"""Anchor RPN: proposal generation and training losses (port of ``models/rpn.py``).

Fixed-capacity, masked outputs like the JAX package, so that the two
compare row for row: per-level top-k, decode of the survivors only, clip,
small-box / score filters, NMS per (scene, level), and a global top-k.  The
losses are ``rpn_losses`` split in three steps -- ``assign_anchors``
(matching, per scene), ``sample_anchors`` (balanced sampling) and
``rpn_losses_at`` (the loss terms at the sampled rows) -- so that a test
can feed the JAX package's sampled indices to the last one.  The anchor
tables come from ``models/anchors.py``, the port's copy of the JAX package's
numpy module.
Boxes are AABBs (6 deltas an anchor) or, with ``RPNConfig.rotated``, OBBs
coded against the AABB anchors by the midpoint-offset coder (8 deltas).
The regression loss is smooth-L1 on the deltas or, for OBBs, one of the
rotated IoU losses (``iou``, ``linear_iou``, ``giou``, ``diou``) on the
sampled rows' decoded proposals.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from nerf_rpn_tpu_torch.models import anchors as anchor_lib
from nerf_rpn_tpu_torch.ops import coders
from nerf_rpn_tpu_torch.ops.aabb import (
    clip_boxes_to_grid,
    obb_center_valid_mask,
    pairwise_iou_aabb,
    small_box_mask,
)
from nerf_rpn_tpu_torch.ops.nms import NEG_INF, nms_mask
from nerf_rpn_tpu_torch.ops.obb import obb2hbb_3d, obb2points_3d
from nerf_rpn_tpu_torch.ops.rotated_iou import diou_rotated_3d, giou_rotated_3d, iou_rotated_3d
from nerf_rpn_tpu_torch.ops.topk import safe_top_k
from nerf_rpn_tpu_torch.parallel import ddp
from nerf_rpn_tpu_torch.utils.losses import bce_with_logits, smooth_l1
from nerf_rpn_tpu_torch.utils.projection import project_points
from nerf_rpn_tpu_torch.utils.target_assign import match_anchors, sample_balanced_indices


REG_LOSS_TYPES = ("smooth_l1", "iou", "linear_iou", "giou", "diou")


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    """Static RPN configuration (defaults = the reference CLI's)."""

    rotated: bool = False
    fg_iou_thresh: float = 0.35
    bg_iou_thresh: float = 0.2
    batch_size_per_mesh: int = 256
    positive_fraction: float = 0.5
    pre_nms_top_n: int = 2500
    post_nms_top_n: int = 2500
    nms_thresh: float = 0.3
    score_thresh: float = 0.0
    reg_loss_type: str = "smooth_l1"
    reg_loss_weight: float = 1.0
    reg_loss_weight_2d: float = 0.0

    # constants of the JAX config that no CLI flag sets
    min_size = 1e-3
    anchor_sizes = anchor_lib.DEFAULT_ANCHOR_SIZES
    aspect_ratios = anchor_lib.DEFAULT_ASPECT_RATIOS

    def __post_init__(self):
        if self.reg_loss_type not in REG_LOSS_TYPES:
            raise ValueError(f"unknown reg_loss_type {self.reg_loss_type!r}")
        if self.reg_loss_type != "smooth_l1" and not self.rotated:
            # the JAX package runs its rotated chain on the 6 AABB columns:
            # column 6 is empty and an out-of-range index clamps, so it
            # scores [x1, y1, x2, y2] as an OBB turned by y2 radians; the
            # port does not train on that value
            raise NotImplementedError(
                f"reg_loss_type {self.reg_loss_type!r} is a rotated IoU loss and needs "
                "OBBs (--rotated_bbox); the AABB IoU loss is not defined in the JAX "
                "package either (ROADMAP.md: \"The JAX package's rotated IoU loss on AABBs\")")

    @property
    def box_dim(self) -> int:
        return 7 if self.rotated else 6

    @property
    def delta_dim(self) -> int:
        return 8 if self.rotated else 6

    def decode(self, deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        if self.rotated:
            return coders.decode_midpoint_offset(deltas, anchors)
        return coders.decode_aabb(deltas, anchors)

    def encode(self, gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        if self.rotated:
            return coders.encode_midpoint_offset(gt, anchors)
        return coders.encode_aabb(gt, anchors)


def build_level_tables(cfg: RPNConfig, mesh_size: Sequence[int],
                       level_shapes: Sequence[Sequence[int]]):
    """Anchors + strides for the padded mesh shape, as numpy constants.

    Returns (anchors (N_total, 6), level_ids (N_total,), strides, counts).
    """
    strides = anchor_lib.level_strides(mesh_size, level_shapes)
    per_level = [
        anchor_lib.grid_anchors(tuple(shape), stride, cfg.anchor_sizes[i],
                                cfg.aspect_ratios[i])
        for i, (shape, stride) in enumerate(zip(level_shapes, strides))
    ]
    counts = [a.shape[0] for a in per_level]
    anchors = np.concatenate(per_level, axis=0)
    level_ids = np.repeat(np.arange(len(per_level), dtype=np.int32), counts)
    return anchors, level_ids, strides, counts


def dynamic_padding_masks_levels(level_shapes: Sequence[Sequence[int]],
                                 strides: Sequence[Sequence[int] | torch.Tensor],
                                 anchors_per_loc: int,
                                 ori_sizes: torch.Tensor) -> list[torch.Tensor]:
    """Per-level (B, N_l) validity masks: anchor cells at index >=
    ceil(ori / stride) sit in zero padding.  ``ori_sizes``: (B, 3) int.

    A stride given as an f32 tensor on ``ori_sizes``' device is used as it
    is: a step that makes them once makes no host-to-device copy per call."""
    masks = []
    b = ori_sizes.shape[0]
    for shape, stride in zip(level_shapes, strides):
        st = (stride if torch.is_tensor(stride)
              else torch.tensor(stride, dtype=torch.float32, device=ori_sizes.device))
        limits = torch.ceil(ori_sizes.float() / st).to(torch.int32)
        axes = [torch.arange(s, device=ori_sizes.device) for s in shape]
        cell_ok = (
            (axes[0][None, :, None, None] < limits[:, 0, None, None, None])
            & (axes[1][None, None, :, None] < limits[:, 1, None, None, None])
            & (axes[2][None, None, None, :] < limits[:, 2, None, None, None])
        )
        masks.append(torch.repeat_interleave(cell_ok.reshape(b, -1),
                                             anchors_per_loc, dim=-1))
    return masks


def dynamic_padding_masks(level_shapes: Sequence[Sequence[int]],
                          strides: Sequence[Sequence[int]], anchors_per_loc: int,
                          ori_sizes: torch.Tensor) -> torch.Tensor:
    """(B, N_total) form of :func:`dynamic_padding_masks_levels`."""
    return torch.cat(dynamic_padding_masks_levels(
        level_shapes, strides, anchors_per_loc, ori_sizes), dim=-1)


def gather_delta_rows_levels(deltas: Sequence[torch.Tensor], idx: torch.Tensor,
                             counts: Sequence[int], anchors_per_loc: int,
                             delta_dim: int) -> torch.Tensor:
    """(B, K, D) delta rows at FLAT anchor indices (order: level, x, y, z,
    anchor), gathered from the head's native per-level (B, X, Y, Z, A*D)
    layout; no (B, N_total, D) concatenation is built."""
    b = idx.shape[0]
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    out = None
    for lvl, d in enumerate(deltas):
        d = d.reshape(b, -1, anchors_per_loc * delta_dim)
        local = (idx - int(offsets[lvl])).clamp(0, int(counts[lvl]) - 1)
        val = _select_deltas(d, local, delta_dim)
        in_level = (idx >= int(offsets[lvl])) & (idx < int(offsets[lvl + 1]))
        val = torch.where(in_level[..., None], val, 0.0)
        out = val if out is None else out + val
    return out


def _select_deltas(dl: torch.Tensor, top_i: torch.Tensor, delta_dim: int) -> torch.Tensor:
    """(B, k, D) delta rows at flat anchor indices, from the head's native
    voxel-major (B, V_l, A*D) layout (flat index = vox * A + a)."""
    b, k = top_i.shape
    a_per = dl.shape[-1] // delta_dim
    vox, a = top_i // a_per, top_i % a_per
    rows = torch.gather(dl, 1, vox[..., None].expand(b, k, dl.shape[-1]))
    rows = rows.reshape(b, k, a_per, delta_dim)
    idx = a[..., None, None].expand(b, k, 1, delta_dim)
    return torch.gather(rows, 2, idx)[:, :, 0]


def generate_proposals_levels(cfg: RPNConfig,
                              objectness: Sequence[torch.Tensor],
                              pred_deltas: Sequence[torch.Tensor],
                              anchors: Sequence[torch.Tensor],
                              grid: torch.Tensor,
                              padding_masks: Sequence[torch.Tensor] | None = None):
    """Fixed-capacity proposal generation on per-level head outputs.

    ``objectness`` per level (B, N_l); ``pred_deltas`` per level in the
    head's native (B, V_l, A*D) layout; ``anchors`` per level (N_l, 6) f32;
    ``grid`` the (3,) f32 grid size, on the outputs' device (made once by
    the caller, so that no call copies it from the host): AABBs are clipped
    to it, OBBs whose centre leaves it are dropped.

    Returns dict with boxes (B, K, 6|7), scores (B, K), level_idx (B, K)
    and valid (B, K) -- K = post_nms_top_n, score-sorted, masked entries
    last with score 0.
    """
    b = objectness[0].shape[0]
    n_levels = len(objectness)
    k_list = [min(cfg.pre_nms_top_n, o.shape[1]) for o in objectness]
    kmax = max(k_list)
    boxes_l, scores_l = [], []
    for lvl, (obj, dl, anc) in enumerate(zip(objectness, pred_deltas, anchors)):
        s = obj.detach()
        if padding_masks is not None:
            s = torch.where(padding_masks[lvl], s, NEG_INF)
        top_s, top_i = safe_top_k(s, k_list[lvl])
        bx = cfg.decode(_select_deltas(dl, top_i, cfg.delta_dim), anc[top_i])
        pad = kmax - k_list[lvl]
        if pad:
            bx = torch.nn.functional.pad(bx, (0, 0, 0, pad))
            top_s = torch.nn.functional.pad(top_s, (0, pad), value=NEG_INF)
        boxes_l.append(bx)
        scores_l.append(top_s)

    boxes = torch.stack(boxes_l, dim=1)          # (B, L, kmax, 6|7)
    raw_scores = torch.stack(scores_l, dim=1)    # (B, L, kmax)
    levels = torch.arange(n_levels, dtype=torch.int32,
                          device=raw_scores.device)[None, :, None].expand_as(raw_scores)
    probs = torch.sigmoid(raw_scores)

    if cfg.rotated:
        valid = obb_center_valid_mask(boxes, grid.to(boxes.dtype))
        valid &= small_box_mask(boxes, cfg.min_size)
    else:
        boxes = clip_boxes_to_grid(boxes, grid.to(boxes.dtype))
        valid = small_box_mask(boxes, cfg.min_size)
    valid &= probs >= cfg.score_thresh
    valid &= raw_scores > NEG_INF / 2  # padded-anchor / padded-slot sentinels

    # NMS per (scene, level): suppression is per level (the reference's
    # batched-NMS category semantics), so B*L independent problems
    d = cfg.box_dim
    keep = nms_mask(boxes.reshape(b * n_levels, kmax, d),
                    probs.reshape(b * n_levels, kmax),
                    valid.reshape(b * n_levels, kmax), cfg.nms_thresh)

    masked = torch.where(keep.reshape(b, n_levels, kmax), probs, NEG_INF)
    masked = masked.reshape(b, n_levels * kmax)
    top_s, top_i = safe_top_k(masked, cfg.post_nms_top_n)
    flat_boxes = boxes.reshape(b, n_levels * kmax, d)
    out_boxes = torch.gather(flat_boxes, 1, top_i[..., None].expand(-1, -1, d))
    out_levels = torch.gather(levels.reshape(b, n_levels * kmax), 1, top_i)
    return {
        "boxes": out_boxes,
        "scores": top_s.clamp_min(0.0),
        "level_idx": out_levels,
        "valid": top_s > NEG_INF / 2,
    }


def voxel_objectness_scores(logits: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Per-level max-over-anchors objectness (B, X, Y, Z)."""
    return [l.reshape(*l.shape[:4], -1).amax(dim=-1) for l in logits]


# ---------------------------------------------------------------------------
# Training losses
# ---------------------------------------------------------------------------


def rotated_iou_loss(pred: torch.Tensor, target: torch.Tensor, loss_type: str) -> torch.Tensor:
    """Per-box rotated IoU loss of (..., 7) OBBs (``_rotated_iou_loss`` of
    the JAX package): ``iou`` / ``linear_iou`` on the (+1)-smoothed volume
    ratio, ``giou`` / ``diou`` with the smallest enclosing box."""
    if loss_type in ("iou", "linear_iou"):
        ious, _, _, _, unions = iou_rotated_3d(pred, target, verbose=True)
        smooth_iou = (ious * unions + 1.0) / (unions + 1.0)
        return -torch.log(smooth_iou) if loss_type == "iou" else 1.0 - smooth_iou
    if loss_type == "giou":
        return giou_rotated_3d(pred, target)[0]
    if loss_type == "diou":
        return diou_rotated_3d(pred, target)[0]
    raise NotImplementedError(loss_type)


def assign_anchors(cfg: RPNConfig, anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_mask: torch.Tensor, padding_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N) matches of the (N, 6) anchors to the (B, G, 6|7) zero-padded
    gt boxes: gt index, -1 background, -2 ignore (padded anchors included).
    OBBs are matched by their enclosing AABBs.

    One scene at a time: the (G, N) IoU matrix of a scene is already
    243 MB in f32 at the train shape (G = 64, N = 950,625).
    """
    out = []
    for i in range(gt_boxes.shape[0]):
        gt = obb2hbb_3d(gt_boxes[i]) if cfg.rotated else gt_boxes[i]
        iou = pairwise_iou_aabb(gt, anchors)
        if padding_mask is not None:
            iou = torch.where(padding_mask[i][None, :], iou, -1.0)
        matches = match_anchors(iou, gt_mask[i], cfg.fg_iou_thresh, cfg.bg_iou_thresh,
                                allow_low_quality=True)
        if padding_mask is not None:
            matches = torch.where(padding_mask[i], matches, -2)
        out.append(matches)
    return torch.stack(out)


def sample_anchors(cfg: RPNConfig, matches: torch.Tensor, generator: torch.Generator):
    """Balanced sample of each scene's anchors: ``(pos_idx, pos_take,
    neg_idx, neg_take)``, each (B, K)."""
    return sample_balanced_indices(matches, cfg.batch_size_per_mesh,
                                   cfg.positive_fraction, generator=generator)


def rpn_losses_at(cfg: RPNConfig, objectness: torch.Tensor,
                  pred_deltas: Sequence[torch.Tensor], anchors: torch.Tensor,
                  gt_boxes: torch.Tensor, matches: torch.Tensor, indices, *,
                  level_counts: Sequence[int], anchors_per_loc: int,
                  max_mesh_dim: int = 160) -> dict[str, torch.Tensor]:
    """The RPN loss terms at the sampled anchors ``indices = (pos_idx,
    pos_take, neg_idx, neg_take)``.

    ``objectness`` (B, N); ``pred_deltas`` the head's native per-level
    outputs, split from the flat anchor index by ``level_counts`` and
    ``anchors_per_loc``.  Every normaliser is summed over the whole batch,
    the global one under a process group (summed over the ranks, then
    clamped): ``num_sampled = max(sum(pos_take) + sum(neg_take), 1)``.  The
    box term is smooth-L1 on the deltas, or the rotated IoU loss of the
    decoded proposals against their matched gt boxes.
    """
    pos_idx, pos_take, neg_idx, neg_take = indices
    b = objectness.shape[0]
    n_pos, n_neg = ddp.all_reduce_sum(pos_take.sum(), neg_take.sum())
    num_sampled = torch.clamp_min(n_pos + n_neg, 1).float()
    num_pos = torch.clamp_min(n_pos, 1).float()

    obj_pos = torch.gather(objectness, 1, pos_idx)
    obj_neg = torch.gather(objectness, 1, neg_idx)
    obj_loss = (
        torch.sum(bce_with_logits(obj_pos, torch.ones_like(obj_pos)) * pos_take)
        + torch.sum(bce_with_logits(obj_neg, torch.zeros_like(obj_neg)) * neg_take)
    ) / num_sampled

    k_matches = torch.gather(matches, 1, pos_idx).clamp_min(0)
    matched_gt = torch.gather(gt_boxes, 1, k_matches[..., None].expand(-1, -1, gt_boxes.shape[-1]))
    k_anchors = anchors[pos_idx]
    k_deltas = gather_delta_rows_levels(pred_deltas, pos_idx, level_counts,
                                        anchors_per_loc, cfg.delta_dim)
    proposals = None
    if cfg.reg_loss_type == "smooth_l1":
        reg = smooth_l1(k_deltas, cfg.encode(matched_gt, k_anchors), beta=1.0 / 9)
        reg_loss = torch.sum(reg * pos_take[..., None]) / num_sampled
    else:
        proposals = cfg.decode(k_deltas, k_anchors)
        per_box = rotated_iou_loss(proposals, matched_gt, cfg.reg_loss_type)
        reg_loss = torch.sum(per_box * pos_take) / num_sampled
    losses = {"loss_objectness": obj_loss, "loss_rpn_box_reg": reg_loss}

    if cfg.reg_loss_weight_2d > 0:
        k = pos_idx.shape[1]
        if proposals is None:
            proposals = cfg.decode(k_deltas, k_anchors)
        # two points a box through the four cameras: an OBB's rotated
        # diagonal, an AABB's (min corner, max corner)
        if cfg.rotated:
            pred_pts, tgt_pts = obb2points_3d(proposals), obb2points_3d(matched_gt)
        else:
            pred_pts = proposals.reshape(b, k, 2, 3)
            tgt_pts = matched_gt.reshape(b, k, 2, 3)
        pred_uv = project_points(pred_pts, max_mesh_dim)
        tgt_uv = project_points(tgt_pts, max_mesh_dim)
        l2d = smooth_l1(pred_uv, tgt_uv, beta=1.0 / 9)
        losses["loss_rpn_box_reg_2d"] = (
            torch.sum(l2d * pos_take[..., None, None, None]) / num_pos / max_mesh_dim)
    else:
        losses["loss_rpn_box_reg_2d"] = torch.zeros((), device=objectness.device)
    return losses


def rpn_losses(cfg: RPNConfig, generator: torch.Generator, objectness: torch.Tensor,
               pred_deltas: Sequence[torch.Tensor], anchors: torch.Tensor,
               gt_boxes: torch.Tensor, gt_mask: torch.Tensor, *,
               level_counts: Sequence[int], anchors_per_loc: int,
               padding_mask: torch.Tensor | None = None, max_mesh_dim: int = 160,
               indices=None) -> dict[str, torch.Tensor]:
    """Objectness BCE, box regression and the 2D projection term
    (``rpn_losses`` of the JAX package): assign, sample (from ``generator``,
    unless ``indices`` are given), then the losses at the sampled rows."""
    with torch.no_grad():
        matches = assign_anchors(cfg, anchors, gt_boxes, gt_mask, padding_mask)
        if indices is None:
            indices = sample_anchors(cfg, matches, generator)
    return rpn_losses_at(cfg, objectness, pred_deltas, anchors, gt_boxes, matches, indices,
                         level_counts=level_counts, anchors_per_loc=anchors_per_loc,
                         max_mesh_dim=max_mesh_dim)
