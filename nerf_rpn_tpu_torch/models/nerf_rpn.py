"""Backbone + detection head (port of ``nerf_rpn_tpu/models/nerf_rpn.py``).

``NeRFRPN`` is a backbone and the anchor RPN head, ``FCOSOverNeRF`` a
backbone and the anchor-free FCOS head.  ``build_backbone`` has the JAX
package's table: the Swin variants, ``resnet`` / ``resnet_tiny``
(``models/resnet.py``) and ``vgg_AF`` / ``vgg_EF`` (``models/vgg.py``, whose
stem depends on ``resolution``).  The heads take their width from the
backbone (``resnet_tiny`` gives 32 channels, the others 256).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from nerf_rpn_tpu_torch.models.heads import FCOSHead3D, RPNHead3D
from nerf_rpn_tpu_torch.models.resnet import ResNetFPN256
from nerf_rpn_tpu_torch.models.swin import SWIN_VARIANTS, SwinFPN
from nerf_rpn_tpu_torch.models.vgg import VGGFPN

def build_backbone(backbone_type: str, resolution: int = 160,
                   dtype: torch.dtype = torch.float32) -> nn.Module:
    """The JAX package's table (``nerf_rpn_tpu/models/nerf_rpn.py:25-53``)."""
    if backbone_type == "resnet":
        return ResNetFPN256((3, 4, 6, 3), is_max_pool=True, dtype=dtype)
    if backbone_type == "resnet_tiny":
        # the CI / quality-gate variant: the same topology, minimal width and depth
        return ResNetFPN256((1, 1, 1, 1), base_width=8, out_channels=32, is_max_pool=True,
                            dtype=dtype)
    if backbone_type in ("vgg_AF", "vgg_EF"):
        return VGGFPN(cfg=backbone_type[4:], input_size=resolution, dtype=dtype)
    if backbone_type in SWIN_VARIANTS:
        return SwinFPN(**SWIN_VARIANTS[backbone_type], dtype=dtype)
    raise ValueError(f"Unknown backbone {backbone_type}")


class NeRFRPN(nn.Module):
    """Returns (features, logits, deltas), each a per-level list; with
    ``rotated`` the head predicts 8 midpoint-offset deltas per anchor."""

    def __init__(self, backbone_type: str = "swin_s", num_anchors: int = 13,
                 conv_depth: int = 4, rotated: bool = False,
                 dtype: torch.dtype = torch.float32, resolution: int = 160):
        super().__init__()
        self.backbone_type = backbone_type
        self.num_anchors = num_anchors
        self.conv_depth = conv_depth
        self.rotated = rotated
        self.dtype = dtype
        self.backbone = build_backbone(backbone_type, resolution, dtype)
        self.rpn_head = RPNHead3D(self.backbone.out_channels, num_anchors, conv_depth,
                                  rotated, dtype)

    def forward(self, grids: torch.Tensor, generator: torch.Generator | None = None,
                space=None):
        """``generator`` draws the Swin backbone's stochastic-depth masks in
        train mode (unused in eval and by the CNN backbones).  ``space``:
        the grids' slabs on the space axis (``parallel/space.py``); every
        output is then this rank's slab of its level,
        ``self.level_slabs(space)``."""
        if space is None:
            features = list(self.backbone(grids, generator))
            logits, deltas = self.rpn_head(features)
            return features, logits, deltas
        slabs = self.level_slabs(space)
        features = list(self.backbone(grids, generator, space))
        logits, deltas = self.rpn_head(features, slabs)
        return features, logits, deltas

    def level_slabs(self, space) -> list:
        """The levels' slabs for the grids' slabs ``space`` (every backbone
        of the table takes the space axis)."""
        return self.backbone.level_slabs(space)


class FCOSOverNeRF(nn.Module):
    """Returns (features, cls, reg, ctr), each a per-level list; with
    ``rotated`` the head predicts 8 box channels (6 distances + the 2
    midpoint offsets of an OBB)."""

    def __init__(self, backbone_type: str = "swin_s", num_convs: int = 4,
                 rotated: bool = False, norm_reg_targets: bool = True,
                 centerness_on_reg: bool = True,
                 fpn_strides: Sequence[int] = (4, 8, 16, 32),
                 dtype: torch.dtype = torch.float32, resolution: int = 160):
        super().__init__()
        self.backbone_type = backbone_type
        self.num_convs = num_convs
        self.rotated = rotated
        self.fpn_strides = tuple(fpn_strides)
        self.dtype = dtype
        self.backbone = build_backbone(backbone_type, resolution, dtype)
        self.fcos_head = FCOSHead3D(self.backbone.out_channels, len(self.fpn_strides),
                                    num_convs, rotated, centerness_on_reg, norm_reg_targets,
                                    self.fpn_strides, dtype)

    def forward(self, grids: torch.Tensor, generator: torch.Generator | None = None,
                space=None):
        """``generator`` draws the Swin backbone's stochastic-depth masks in
        train mode (unused in eval and by the CNN backbones).  ``space``:
        the grids' slabs on the space axis; every output is then this
        rank's slab of its level, ``self.level_slabs(space)``."""
        if space is None:
            features = list(self.backbone(grids, generator))
            cls, reg, ctr = self.fcos_head(features)
            return features, cls, reg, ctr
        features = list(self.backbone(grids, generator, space))
        cls, reg, ctr = self.fcos_head(features, self.level_slabs(space))
        return features, cls, reg, ctr

    def level_slabs(self, space) -> list:
        """The levels' slabs for the grids' slabs ``space``."""
        return self.backbone.level_slabs(space)


# flax's lecun_normal is variance_scaling(1, "fan_in", "truncated_normal"):
# a standard normal cut at +-2 and divided by its std after the cut, this
# constant, before it is scaled by 1/sqrt(fan_in)
TRUNCATED_STD = 0.87962566103423978
# the prior probability of an object that the FCOS class bias starts at
FCOS_PRIOR_PROB = 0.01


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator`` with the flax initialisers' laws:
    LeCun-normal kernels (normal cut at +-2 sigma, sigma =
    1/(0.8796 sqrt(fan_in)), flax's ``lecun_normal``), zero biases, unit
    LayerNorm scales, relative-position tables from
    ``truncated_normal(0.02)`` (cut at +-0.04, no rescale) and N(0, 0.01)
    RPN-head, RCNN-head (``head.``) and FCOS-head kernels (flax
    ``normal(0.01)``, not truncated).
    The draws come from ``generator`` on the parameters' device (a CUDA
    generator for a model on the card).
    BatchNorms, found by module type, start at weight 1, bias 0, running
    mean 0 and running variance 1.  The FCOS head's GroupNorms start at
    weight 1 and bias 0, its scales at 1, and its class logits' bias at
    -log((1 - p) / p), p = 0.01 (the focal loss's prior)."""
    batch_norms = {f"{name}.{leaf}" for name, m in model.named_modules()
                   if isinstance(m, nn.BatchNorm3d)
                   for leaf in ("weight", "bias")}
    for m in model.modules():
        if isinstance(m, nn.BatchNorm3d):
            m.reset_running_stats()
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in batch_norms:
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif name.startswith("fcos_head."):
            if p.dim() == 5:
                p.copy_(torch.randn(p.shape, generator=generator, dtype=p.dtype, device=p.device) * 0.01)
            elif name == "fcos_head.cls_logits.bias":
                p.fill_(-math.log((1 - FCOS_PRIOR_PROB) / FCOS_PRIOR_PROB))
            else:  # GroupNorm weights and scales 1, biases 0
                p.fill_(0.0 if leaf == "bias" else 1.0)
        elif leaf == "relative_position_bias_table":
            torch.nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=generator)
        elif ".norm" in name or "patch_partition.2" in name:
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            p.zero_()
        elif name.startswith(("rpn_head.", "head.")):
            p.copy_(torch.randn(p.shape, generator=generator, dtype=p.dtype, device=p.device) * 0.01)
        else:
            std = 1.0 / math.sqrt(p[0].numel()) / TRUNCATED_STD
            torch.nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std,
                                        generator=generator)
