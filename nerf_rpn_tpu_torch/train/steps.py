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
``voxel_scores``.  It is two parts, exposed as ``eval_step.forward`` (grids
-> per-level head outputs) and ``eval_step.propose`` (head outputs ->
proposals), which the benchmark times separately.  The JAX package's split
compile units exist for the TPU compiler and are not ported.

The FCOS steps have the same shape.  ``train_step(state, batch,
drop_generator)`` takes one generator only, for stochastic depth: FCOS's
target assignment is deterministic.  Its metrics add ``dropped_positives``,
the positives beyond the loss's gather capacity (``models/fcos.py``).
``eval_step.forward`` gives the flattened (B, L, .) head outputs and the
voxel scores, ``eval_step.propose`` the proposals.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from nerf_rpn_tpu_torch.models import fcos as fcos_lib
from nerf_rpn_tpu_torch.models import rpn as rpn_lib
from nerf_rpn_tpu_torch.models.fcos import FCOSConfig
from nerf_rpn_tpu_torch.models.rpn import RPNConfig
from nerf_rpn_tpu_torch.train.state import global_norm


def level_shapes_for(mesh_shape: Sequence[int], strides: Sequence[int]):
    """Feature shapes per FPN level (ceil-divided spatial dims)."""
    return [tuple(-(-int(m) // s) for m in mesh_shape) for s in strides]


def _level_tables(model, cfg: RPNConfig, mesh_shape, strides):
    if model.rotated != cfg.rotated:
        raise ValueError(f"the model predicts {'OBB' if model.rotated else 'AABB'} deltas "
                         f"and the RPN config codes {'OBBs' if cfg.rotated else 'AABBs'}")
    shapes = level_shapes_for(mesh_shape, strides)
    anchors_np, _, level_strides, counts = rpn_lib.build_level_tables(cfg, mesh_shape, shapes)
    return shapes, anchors_np, level_strides, counts


def make_rpn_train_step(model, cfg: RPNConfig, mesh_shape: Sequence[int],
                        strides: Sequence[int] = (4, 8, 16, 32),
                        device: torch.device | str = "cpu"):
    """Returns ``train_step(state, batch, generator, drop_generator,
    indices=None) -> metrics``.

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
        _, logits, deltas = model(grids, drop_generator)
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
        return {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()},
                "grad_norm": grad_norm,
                "param_norm": global_norm(list(model.parameters()))}

    return train_step


def make_rpn_eval_step(model, cfg: RPNConfig, mesh_shape: Sequence[int],
                       strides: Sequence[int] = (4, 8, 16, 32),
                       device: torch.device | str = "cpu"):
    """Returns eval_step(grids (B, X, Y, Z, 4), ori_sizes (B, 3)) -> dict,
    with boxes (B, K, ``cfg.box_dim``)."""
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
        feats, logits, deltas = model(grids)
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
        _, obj, dl, vox = forward(grids)
        out = propose(obj, dl, ori_sizes)
        out["voxel_scores"] = vox
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
    if model.rotated != cfg.rotated:
        raise ValueError(f"the model predicts {'OBB' if model.rotated else 'AABB'} targets "
                         f"and the FCOS config codes {'OBBs' if cfg.rotated else 'AABBs'}")
    shapes = level_shapes_for(mesh_shape, cfg.fpn_strides)
    loc, _, counts, stride_of, soi = fcos_lib.fcos_locations(shapes, cfg.fpn_strides)
    return ([torch.from_numpy(a).to(device) for a in (loc, stride_of, soi)], counts)


def make_fcos_train_step(model, cfg: FCOSConfig, mesh_shape: Sequence[int],
                         device: torch.device | str = "cpu"):
    """Returns ``train_step(state, batch, drop_generator) -> metrics``.

    ``batch`` as the RPN step's, with (B, G, 6|7) ``gt_boxes``.  Metrics:
    ``loss`` (the sum of the three terms), ``loss_cls``, ``loss_reg``,
    ``loss_centerness``, ``dropped_positives``, ``grad_norm`` (pre-clip)
    and ``param_norm`` (after the update), device tensors all.
    """
    (loc, stride_of, soi), _ = _fcos_tables(model, cfg, mesh_shape, device)

    def train_step(state, batch, drop_generator):
        model.train()
        _, cls, reg, ctr = model(batch["grids"], drop_generator)
        losses = fcos_lib.fcos_losses(
            cfg, fcos_lib.flatten_fcos_outputs(cls, 1),
            fcos_lib.flatten_fcos_outputs(reg, cfg.reg_dim),
            fcos_lib.flatten_fcos_outputs(ctr, 1), loc, stride_of, soi,
            batch["gt_boxes"], batch["gt_mask"],
            padding_mask=fcos_lib.fcos_padding_mask(loc, batch["ori_sizes"]))
        total = losses["loss_cls"] + losses["loss_reg"] + losses["loss_centerness"]
        total.backward()
        grad_norm = state.apply_gradients()
        return {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()},
                "grad_norm": grad_norm,
                "param_norm": global_norm(list(model.parameters()))}

    return train_step


def make_fcos_eval_step(model, cfg: FCOSConfig, mesh_shape: Sequence[int],
                        device: torch.device | str = "cpu"):
    """Returns eval_step(grids (B, X, Y, Z, 4), ori_sizes (B, 3)) -> dict of
    boxes (B, K, 6|7), scores, level_idx, valid (B, K) and voxel_scores."""
    (loc, _, _), counts = _fcos_tables(model, cfg, mesh_shape, device)

    @torch.inference_mode()
    def forward(grids: torch.Tensor):
        model.eval()
        _, cls, reg, ctr = model(grids)
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
