"""The anchor-RPN and FCOS train and eval steps (port of ``make_rpn_train_step``,
``make_rpn_eval_step``, ``make_fcos_train_step`` and ``make_fcos_eval_step``,
``nerf_rpn_tpu/train/steps.py``).

``train_step(state, batch, generator, drop_generator)`` runs the model in
train mode, the RPN losses, the backward (kernel K2 inside the attention's
autograd function on CUDA) and the clipped AdamW update, and returns the
JAX step's metrics as device tensors.  Anchor sampling and stochastic depth
draw from separate generators, as the JAX step splits ``key`` and
``drop_key``.

``eval_step(grids, ori_sizes)`` returns the same dict as the JAX step:
boxes / scores / level_idx / valid from ``generate_proposals_levels`` plus
``voxel_scores`` (and the FPN levels with ``return_features``).  It is two
parts, exposed as ``eval_step.forward`` (grids -> per-level head outputs)
and ``eval_step.propose`` (head outputs -> proposals), which the benchmark
times separately.  The JAX package's split compile units exist for the
TPU compiler and are not ported.

A model with BatchNorms (the ResNet and VGG backbones) normalises with the
batch's statistics in the train steps and moves its running statistics
once a step, as the JAX steps' ``mutable=["batch_stats"]`` apply does --
with ``--freeze_backbone`` too, since the JAX step applies the whole model
with ``train=True`` -- and normalises with the running statistics in the
eval steps.  Every step checks that the backbone's levels sit at the
strides of its tables (``check_level_strides``).

The FCOS steps have the same shape.  ``train_step(state, batch,
drop_generator)`` takes one generator only, for stochastic depth: FCOS's
target assignment is deterministic.  Its metrics add ``dropped_positives``,
the positives beyond the loss's gather capacity (``models/fcos.py``).
``eval_step.forward`` gives the flattened (B, L, .) head outputs and the
voxel scores, ``eval_step.propose`` the proposals.

The anchor-RPN and FCOS steps also run on the ``space`` axis (``space=`` a
``parallel/space.SpaceGroups``; ``space.shard_batch`` splits the batch),
on every backbone of the table (Swin, ResNet, VGG): each rank's grids are
its data group's scenes, its slab of their x extent; the model runs on the
slabs (the FCOS head's GroupNorms sum their moments over the space group),
each level's head outputs are gathered over the space group
(``space.gather_x``), and the eval step proposes on every rank of the
group (the replicated result of GSPMD's all-gather), the train step takes
the losses on the gathered outputs, their normalisers and logged terms
summed over the data group.

Under a process group (``parallel/ddp.py``) each rank runs a train step on
its share of the global batch: the losses divide by the global batch's
normalisers, the gradients are summed over the ranks before the clip, the
BatchNorms take the global batch's statistics, and the loss terms and
counts in the metrics are the global batch's.  So every rank takes the
step that one process takes on the whole batch, as the JAX step is one
``jit`` over it.  The eval steps run no collective: rank 0 evaluates alone.

The RCNN steps (``make_rcnn_train_step``, ``make_rcnn_eval_step``,
``make_rcnn_filter_step``) run the second stage on an ``RCNNDetector``:
the FPN levels come from the batch (``features``) or, for
``--fine_tune``, from the model's backbone applied to ``grids`` (train
mode, stochastic depth from ``drop_generator`` and the BatchNorms' batch
statistics, in the train step; the eval route in the eval step).  The
train step samples ``rois_per_image`` RoIs a scene from ``generator``
(``indices`` injects a sample), pools them (``ops/roi_align``), and takes
the head's losses; the eval step scores every RoI; the filter step runs
``filter_refined_proposals`` scene by scene.  The JAX package's
``_rcnn_feature_barrier`` is one of its ``NERF_RPN_TPU_*`` experiment
knobs and is not ported.

The RCNN steps take ``space`` too.  The fine-tune backbone runs on the
rank's slab and each FPN level is gathered over the space group, so that
RoI align, which reads any row of a level, runs on whole levels; the
features mode's levels are whole on every rank already
(``space.shard_batch`` splits them over the data groups only).  Every rank
of a space group samples the same RoIs (the generators follow the data
group), then the train step takes the rank's contiguous block of each
scene's sample (``space.row_block``): RoI align, the head and the losses
run on that block, the loss normalisers and logged terms are summed over
the world, and the levels' gather sums their gradient over the space group
before it keeps the rank's rows (``gather_x(..., sum_grad=True)``).  The
world's gradient sum is then the one process's: the head's gradient of
each block once, and the backbone's of each slab.  The eval step scores
every RoI on every rank of the group.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from nerf_rpn_tpu_torch.models import detector as det
from nerf_rpn_tpu_torch.models import fcos as fcos_lib
from nerf_rpn_tpu_torch.models import rpn as rpn_lib
from nerf_rpn_tpu_torch.models.fcos import FCOSConfig
from nerf_rpn_tpu_torch.models.rpn import RPNConfig
from nerf_rpn_tpu_torch.ops.roi_align import multilevel_roi_align_batched
from nerf_rpn_tpu_torch.parallel import ddp
from nerf_rpn_tpu_torch.parallel import space as sp
from nerf_rpn_tpu_torch.train.state import global_norm


def global_terms(*, over_world: bool = False, **terms: torch.Tensor) -> dict[str, torch.Tensor]:
    """The train metrics that are sums over scenes (the loss terms, each a
    rank's numerator over the global normaliser; the counts), detached and
    summed over the data group's ranks (``over_world``: every rank's, where
    the ranks of a space group hold disjoint parts): the global batch's."""
    return dict(zip(terms, ddp.all_reduce_sum(*(v.detach() for v in terms.values()),
                                              over_world=over_world)))


def level_shapes_for(mesh_shape: Sequence[int], strides: Sequence[int]):
    """Feature shapes per FPN level (ceil-divided spatial dims)."""
    return [tuple(-(-int(m) // s) for m in mesh_shape) for s in strides]


def check_level_strides(model, strides: Sequence[int]) -> None:
    """Raise where the backbone's levels do not sit at ``strides``, which
    the anchor and location tables assume.  VGG below an ``input_size`` of
    160 has a stride-1 stem, so its levels sit at strides (1, 2, 4, 8);
    the JAX package's steps take the fixed (4, 8, 16, 32) there, and its
    eval step fails with a broadcast error while its train step trains on
    tables that do not match the head's outputs."""
    have = tuple(model.backbone.strides)
    if have != tuple(strides):
        raise ValueError(
            f"the {model.backbone_type} backbone's levels sit at strides {have}, not at "
            f"the {tuple(strides)} that the anchor and location tables assume (a VGG "
            "backbone below --resolution 160 has a stride-1 stem); the JAX package's "
            "eval step fails here and its train step trains on mismatched tables")


def _level_tables(model, cfg: RPNConfig, mesh_shape, strides):
    check_level_strides(model, strides)
    if model.rotated != cfg.rotated:
        raise ValueError(f"the model predicts {'OBB' if model.rotated else 'AABB'} deltas "
                         f"and the RPN config codes {'OBBs' if cfg.rotated else 'AABBs'}")
    shapes = level_shapes_for(mesh_shape, strides)
    anchors_np, _, level_strides, counts = rpn_lib.build_level_tables(cfg, mesh_shape, shapes)
    return shapes, anchors_np, level_strides, counts


def _slab_forward(model, grids, generator, groups):
    """The model on this rank's slab of the grids (``groups``: the space
    layout): ``(features, *head outputs, slabs)``, each level's head
    outputs gathered over the space group, the features and the levels'
    slabs as they are."""
    src = sp.input_slab(groups, grids.shape[1] * groups.n_space)
    slabs = model.level_slabs(src)
    feats, *heads = model(grids, generator, src)
    return (feats, *([sp.gather_x(t, sl) for t, sl in zip(out, slabs)] for out in heads),
            slabs)


def make_rpn_train_step(model, cfg: RPNConfig, mesh_shape: Sequence[int],
                        strides: Sequence[int] = (4, 8, 16, 32),
                        device: torch.device | str = "cpu", space=None):
    """Returns ``train_step(state, batch, generator, drop_generator,
    indices=None) -> metrics``.  ``space``: the ``SpaceGroups`` of the
    space axis, ``batch`` then this rank's part (``space.shard_batch``);
    every rank of a space group must draw its generators alike.

    ``batch``: device tensors ``grids`` (B, X, Y, Z, 4), ``ori_sizes``
    (B, 3), ``gt_boxes`` (B, G, ``cfg.box_dim``): AABBs, or OBBs with
    ``cfg.rotated`` (the model's ``rotated`` must agree), ``gt_mask`` (B,
    G).  ``indices`` (``pos_idx, pos_take, neg_idx, neg_take``) replace the
    sampled anchors, for tests that feed the JAX package's sample.  Metrics: ``loss``,
    ``loss_objectness``, ``loss_rpn_box_reg``, ``loss_rpn_box_reg_2d``,
    ``grad_norm`` (pre-clip) and ``param_norm`` (after the update).
    """
    shapes, anchors_np, level_strides, counts = _level_tables(
        model, cfg, mesh_shape, strides)
    anchors = torch.from_numpy(anchors_np).to(device)
    anchors_per_loc = model.num_anchors
    max_dim = int(max(mesh_shape))
    n_levels = len(shapes)

    def train_step(state, batch, generator, drop_generator, indices=None):
        model.train()
        grids = batch["grids"]
        b = grids.shape[0]
        padding = rpn_lib.dynamic_padding_masks(
            shapes, level_strides, anchors_per_loc, batch["ori_sizes"])
        if space is None:
            _, logits, deltas = model(grids, drop_generator)
        else:
            _, logits, deltas, _ = _slab_forward(model, grids, drop_generator, space)
        obj = torch.cat([l.reshape(b, -1) for l in logits[:n_levels]], dim=1)
        # deltas stay in the head's native per-level layout; the loss
        # gathers its K sampled rows level by level
        losses = rpn_lib.rpn_losses(
            cfg, generator, obj, list(deltas[:n_levels]), anchors,
            batch["gt_boxes"], batch["gt_mask"], padding_mask=padding,
            max_mesh_dim=max_dim, level_counts=counts,
            anchors_per_loc=anchors_per_loc, indices=indices)
        total = (losses["loss_objectness"]
                 + cfg.reg_loss_weight * losses["loss_rpn_box_reg"]
                 + cfg.reg_loss_weight_2d * losses["loss_rpn_box_reg_2d"])
        total.backward()
        grad_norm = state.apply_gradients()
        return {**global_terms(loss=total, **losses), "grad_norm": grad_norm,
                "param_norm": global_norm(list(model.parameters()))}

    return train_step


def make_rpn_eval_step(model, cfg: RPNConfig, mesh_shape: Sequence[int],
                       strides: Sequence[int] = (4, 8, 16, 32),
                       device: torch.device | str = "cpu", return_features: bool = False,
                       space=None):
    """Returns eval_step(grids (B, X, Y, Z, 4), ori_sizes (B, 3)) -> dict,
    with boxes (B, K, ``cfg.box_dim``); with ``return_features`` also the
    FPN levels in f32 under ``features`` (``run_rpn --save_results``).
    ``space``: the ``SpaceGroups`` of the space axis; ``grids`` is then
    this rank's slab (``space.shard_grid``) and every rank of the space
    group returns its scenes' whole result (the features gathered too)."""
    shapes, anchors_np, level_strides, counts = _level_tables(
        model, cfg, mesh_shape, strides)
    anchors_per_loc = model.num_anchors
    level_anchors = [torch.from_numpy(a).to(device)
                     for a in np.split(anchors_np, np.cumsum(counts)[:-1])]
    # made on the device once: a tensor made from a Python list on a CUDA
    # device is a synchronous copy, and propose makes none
    level_strides = [torch.tensor(s, dtype=torch.float32, device=device)
                     for s in level_strides]
    grid = torch.tensor(mesh_shape, dtype=torch.float32, device=device)
    n_levels = len(shapes)

    @torch.inference_mode()
    def forward(grids: torch.Tensor):
        model.eval()
        if space is None:
            feats, logits, deltas = model(grids)
        else:
            feats, logits, deltas, slabs = _slab_forward(model, grids, None, space)
            if return_features:
                feats = [sp.gather_x(f, sl) for f, sl in zip(feats, slabs)]
        b = grids.shape[0]
        obj_l = [l.reshape(b, -1) for l in logits[:n_levels]]
        # deltas stay in the head's voxel-major (B, V, A*D) layout; the
        # proposal step selects the anchor on the top-k survivors only
        dl_l = [d.reshape(b, -1, d.shape[-1]) for d in deltas[:n_levels]]
        vox = rpn_lib.voxel_objectness_scores(logits[:n_levels])
        return feats[:n_levels], obj_l, dl_l, vox

    @torch.inference_mode()
    def propose(obj_l, dl_l, ori_sizes: torch.Tensor):
        pads = rpn_lib.dynamic_padding_masks_levels(
            shapes, level_strides, anchors_per_loc, ori_sizes)
        return rpn_lib.generate_proposals_levels(
            cfg, obj_l, dl_l, level_anchors, grid, padding_masks=pads)

    def eval_step(grids: torch.Tensor, ori_sizes: torch.Tensor):
        feats, obj, dl, vox = forward(grids)
        out = propose(obj, dl, ori_sizes)
        out["voxel_scores"] = vox
        if return_features:
            out["features"] = [f.float() for f in feats]
        return out

    eval_step.forward = forward
    eval_step.propose = propose
    return eval_step


# ---------------------------------------------------------------------------
# FCOS
# ---------------------------------------------------------------------------


def _fcos_tables(model, cfg: FCOSConfig, mesh_shape, device):
    """Locations, strides and size-of-interest ranges of every level on the
    device (made once, so that no step copies them from the host), and the
    level counts."""
    check_level_strides(model, cfg.fpn_strides)
    if model.rotated != cfg.rotated:
        raise ValueError(f"the model predicts {'OBB' if model.rotated else 'AABB'} targets "
                         f"and the FCOS config codes {'OBBs' if cfg.rotated else 'AABBs'}")
    shapes = level_shapes_for(mesh_shape, cfg.fpn_strides)
    loc, _, counts, stride_of, soi = fcos_lib.fcos_locations(shapes, cfg.fpn_strides)
    return ([torch.from_numpy(a).to(device) for a in (loc, stride_of, soi)], counts)


def _fcos_forward(model, grids, generator, space):
    """(cls, reg, ctr) level lists of the whole scenes: on the space axis
    each level gathered over the space group."""
    if space is None:
        return model(grids, generator)[1:]
    return _slab_forward(model, grids, generator, space)[1:4]


def make_fcos_train_step(model, cfg: FCOSConfig, mesh_shape: Sequence[int],
                         device: torch.device | str = "cpu", space=None):
    """Returns ``train_step(state, batch, drop_generator) -> metrics``.

    ``batch`` as the RPN step's, with (B, G, 6|7) ``gt_boxes``.  Metrics:
    ``loss`` (the sum of the three terms), ``loss_cls``, ``loss_reg``,
    ``loss_centerness``, ``dropped_positives``, ``grad_norm`` (pre-clip)
    and ``param_norm`` (after the update), device tensors all.  ``space``:
    the ``SpaceGroups`` of the space axis, ``batch`` then this rank's part
    (``space.shard_batch``); every rank of a space group must draw
    ``drop_generator`` alike.
    """
    (loc, stride_of, soi), _ = _fcos_tables(model, cfg, mesh_shape, device)

    def train_step(state, batch, drop_generator):
        model.train()
        cls, reg, ctr = _fcos_forward(model, batch["grids"], drop_generator, space)
        losses = fcos_lib.fcos_losses(
            cfg, fcos_lib.flatten_fcos_outputs(cls, 1),
            fcos_lib.flatten_fcos_outputs(reg, cfg.reg_dim),
            fcos_lib.flatten_fcos_outputs(ctr, 1), loc, stride_of, soi,
            batch["gt_boxes"], batch["gt_mask"],
            padding_mask=fcos_lib.fcos_padding_mask(loc, batch["ori_sizes"]))
        total = losses["loss_cls"] + losses["loss_reg"] + losses["loss_centerness"]
        total.backward()
        grad_norm = state.apply_gradients()
        return {**global_terms(loss=total, **losses), "grad_norm": grad_norm,
                "param_norm": global_norm(list(model.parameters()))}

    return train_step


def make_fcos_eval_step(model, cfg: FCOSConfig, mesh_shape: Sequence[int],
                        device: torch.device | str = "cpu", space=None):
    """Returns eval_step(grids (B, X, Y, Z, 4), ori_sizes (B, 3)) -> dict of
    boxes (B, K, 6|7), scores, level_idx, valid (B, K) and voxel_scores.
    ``space``: the ``SpaceGroups`` of the space axis; ``grids`` is then
    this rank's slab (``space.shard_grid``) and every rank of the space
    group returns its scenes' whole result."""
    (loc, _, _), counts = _fcos_tables(model, cfg, mesh_shape, device)

    @torch.inference_mode()
    def forward(grids: torch.Tensor):
        model.eval()
        cls, reg, ctr = _fcos_forward(model, grids, None, space)
        return (fcos_lib.flatten_fcos_outputs(cls, 1),
                fcos_lib.flatten_fcos_outputs(reg, cfg.reg_dim),
                fcos_lib.flatten_fcos_outputs(ctr, 1),
                fcos_lib.fcos_voxel_scores(cls, ctr))

    @torch.inference_mode()
    def propose(cls_f, reg_f, ctr_f, ori_sizes: torch.Tensor):
        return fcos_lib.fcos_inference(
            cfg, cls_f, reg_f, ctr_f, loc, counts, ori_sizes,
            padding_mask=fcos_lib.fcos_padding_mask(loc, ori_sizes))

    def eval_step(grids: torch.Tensor, ori_sizes: torch.Tensor):
        cls_f, reg_f, ctr_f, vox = forward(grids)
        out = propose(cls_f, reg_f, ctr_f, ori_sizes)
        out["voxel_scores"] = vox
        return out

    eval_step.forward = forward
    eval_step.propose = propose
    return eval_step


# ---------------------------------------------------------------------------
# RCNN second stage
# ---------------------------------------------------------------------------


def _rcnn_features(model, batch, drop_generator=None, space=None, sum_grad=False):
    """The FPN levels of the batch's scenes: the features mode's, or the
    backbone's of ``grids`` -- on the space axis of the rank's slab, each
    level gathered over the space group (``sum_grad``: the gather's backward
    sums the gradient over the group, for ranks that pool other RoIs)."""
    if model.backbone is None:
        return list(batch["features"])
    if space is None:
        return list(model.backbone(batch["grids"], drop_generator))
    grids = batch["grids"]
    src = sp.input_slab(space, grids.shape[1] * space.n_space)
    slabs = model.backbone.level_slabs(src)
    return [sp.gather_x(f, sl, sum_grad) for f, sl in
            zip(model.backbone(grids, drop_generator, src), slabs)]


def rcnn_pool(cfg: det.RCNNConfig, features, rois, levels, valid, spatial_scales):
    """(B, R, ox, oy, oz, C) pooled features of the RoIs at their levels."""
    return multilevel_roi_align_batched(
        features, rois, levels, valid, spatial_scales, cfg.output_size, cfg.sampling_ratio,
        cfg.pool_mode, rotated=cfg.rotated, enlarge_scale=cfg.enlarge_scale)


def make_rcnn_train_step(model, cfg: det.RCNNConfig, spatial_scales: Sequence[float],
                         rois_per_image: int, reg_loss_weight: float = 1.0,
                         obj_only: bool = False, space=None):
    """Returns ``train_step(state, batch, generator, drop_generator=None,
    indices=None) -> metrics`` (the reference's ``Classification_Model.
    forward`` + ``train_epoch``; the loss combination of
    ``run_rpn_detect.py:358-362``: the box term times ``reg_loss_weight``,
    left out of the total with ``obj_only``).

    ``batch``: device tensors ``rois`` (B, R, D), ``roi_levels``,
    ``roi_valid`` (B, R), ``gt_boxes`` (B, G, D), ``gt_mask`` (B, G) and
    ``features`` (a list of (B, X_l, Y_l, Z_l, C)) or, with a backbone,
    ``grids``.  ``indices`` (B, ``rois_per_image``) replaces the sampled
    RoIs.  Metrics: ``loss``, ``loss_objectness``, ``loss_rpn_box_reg``,
    ``grad_norm`` (pre-clip), ``param_norm`` (after the update) and the
    sampled ``fg_rois`` / ``bg_rois``, device tensors all.  ``space``: the
    ``SpaceGroups`` of the space axis, ``batch`` then this rank's part
    (``space.shard_batch``); every rank of a space group must draw its
    generators (or take ``indices``) alike.
    """
    d = cfg.box_dim
    split = space is not None

    def train_step(state, batch, generator, drop_generator=None, indices=None):
        model.train()
        features = _rcnn_features(model, batch, drop_generator, space, sum_grad=True)
        s = det.sample_rois(cfg, generator, batch["rois"], batch["roi_levels"],
                            batch["roi_valid"], batch["gt_boxes"], batch["gt_mask"],
                            rois_per_image, indices=indices)
        if split:  # this rank's block of each scene's sample
            block = sp.row_block(rois_per_image, space)
            s = {k: v[:, block] for k, v in s.items()}
        pooled = rcnn_pool(cfg, features, s["boxes"], s["levels"], s["valid"], spatial_scales)
        deltas, scores = model.head(pooled.flatten(0, 1))
        losses = det.rcnn_losses(cfg, deltas, scores, s["labels"].reshape(-1),
                                 s["matched_gt"].reshape(-1, d), s["boxes"].reshape(-1, d),
                                 s["valid"].reshape(-1), over_world=split)
        losses["loss_rpn_box_reg"] = losses["loss_rpn_box_reg"] * reg_loss_weight
        if obj_only:
            total = losses["loss_objectness"]
        else:
            total = losses["loss_objectness"] + losses["loss_rpn_box_reg"]
        total.backward()
        if obj_only:  # the box layer's gradient is 0, as in JAX: AdamW still decays it
            for p in state.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        grad_norm = state.apply_gradients()
        fg = s["labels"] > 0
        return {**global_terms(loss=total, **losses, fg_rois=(fg & s["valid"]).sum(),
                               bg_rois=(~fg & s["valid"]).sum(), over_world=split),
                "grad_norm": grad_norm, "param_norm": global_norm(list(model.parameters()))}

    return train_step


def make_rcnn_eval_step(model, cfg: det.RCNNConfig, spatial_scales: Sequence[float],
                        space=None):
    """Returns ``eval_step(batch) -> dict`` that scores every RoI (no
    sampling; the reference's ``cls_batch_size`` chunks are not needed):
    ``scores`` (B, R, 2) softmax probabilities, ``refined_boxes`` (B, R,
    D) decoded from the RoIs, ``labels`` (B, R) and ``valid``.  The parts
    are ``eval_step.features(batch)`` (the FPN levels),
    ``eval_step.pool(features, batch)`` (RoI align) and
    ``eval_step.head(pooled, batch)`` (the labels, the head, softmax and
    decode).  ``space``: the ``SpaceGroups`` of the space axis, ``batch``
    then this rank's part (``space.shard_batch``); every rank of the space
    group scores its scenes' every RoI on the gathered levels."""

    @torch.inference_mode()
    def features(batch):
        model.eval()
        return _rcnn_features(model, batch, space=space)

    @torch.inference_mode()
    def pool(feats, batch):
        return rcnn_pool(cfg, feats, batch["rois"], batch["roi_levels"], batch["roi_valid"],
                         spatial_scales)

    @torch.inference_mode()
    def head(pooled, batch):
        model.eval()
        rois, valid = batch["rois"], batch["roi_valid"]
        labels, _ = det.label_all_rois(cfg, rois, valid, batch["gt_boxes"], batch["gt_mask"])
        b, r = pooled.shape[:2]
        deltas, scores = model.head(pooled.flatten(0, 1))
        return {"scores": torch.softmax(scores, dim=-1).reshape(b, r, -1),
                "refined_boxes": cfg.decode(deltas.reshape(b, r, -1), rois),
                "labels": labels, "valid": valid}

    def eval_step(batch):
        return head(pool(features(batch), batch), batch)

    eval_step.features = features
    eval_step.pool = pool
    eval_step.head = head
    return eval_step


def make_rcnn_filter_step(cfg: det.RCNNConfig, score_threshold: float, nms_threshold: float,
                          num_threshold: int, min_size: float = 1e-3):
    """Returns ``filter_step(boxes (B, R, D), probs (B, R, 2), valid (B, R),
    mesh_sizes (B, 3)) -> (boxes, keep, order)``, each (B, R, .):
    ``filter_refined_proposals`` one scene at a time (reference
    ``filter_proposals``, ``run_rpn_detect.py:403-439``)."""

    @torch.inference_mode()
    def filter_step(boxes, probs, valid, mesh_sizes):
        out = [det.filter_refined_proposals(cfg, boxes[i], probs[i], valid[i], mesh_sizes[i],
                                            score_threshold, nms_threshold, num_threshold,
                                            min_size)
               for i in range(boxes.shape[0])]
        return tuple(torch.stack(t) for t in zip(*out))

    return filter_step
