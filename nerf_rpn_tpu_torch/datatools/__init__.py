"""Dataset preparation: ScanNet frame selection and COLMAP seeding
(``prepare_scannet``), ScanNet and Hypersim box files (``scannet_boxes``,
``hypersim_boxes``) and NeRF -> rgbsigma grids (``nerf_features``, the one
with device work).  The counterpart of ``nerf_rpn_tpu/datatools``."""
