"""Anchor-free FCOS over NeRF: target assignment, losses, inference (port of
``nerf_rpn_tpu/models/fcos.py``).

- Targets: per-level size-of-interest ranges [-1, 16], [16, 32], [32, 64],
  [64, INF]; center sampling with radius x stride clamped into the gt box;
  the least-volume gt wins a location, on ties the lowest gt index (the
  rule of ``argmin``); OBB targets by ``encode_fcos_obb`` per (location,
  gt).  One broadcast (L, G) computation a scene, gt boxes padded with a
  mask.
- Losses: sigmoid focal loss over every location (sum / number of
  positives), the IoU-family or smooth-L1 box loss weighted by the
  centerness targets and normalised by their sum, centerness BCE, and
  optionally the extra L1 on the OBB midpoint offsets and the 2D
  projection loss.  The box and centerness terms see only positive
  locations: the positives are gathered to a fixed capacity ``K = min(L,
  128 G)`` first, as in the JAX package.  Where a scene has more than K
  positives (a larger ``center_sampling_radius``) the rest are dropped, as
  in JAX; the port counts them and returns the count as the device scalar
  ``dropped_positives`` (no host sync), which the trainer reports.
- Inference: per level sigmoid scores (padding at -1e5), candidates above
  ``pre_nms_thresh``, the top ``pre_nms_top_n`` by score x centerness,
  decode, remove-small, scores sqrt(cls x ctr), then cross-level
  single-class NMS, one problem per scene (``ops/nms.nms_mask``), and the
  top ``fpn_post_nms_top_n``.

Fixed-capacity, masked outputs, so that they compare row for row with the
JAX package's; the location tables are numpy, made once per mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from nerf_rpn_tpu_torch.models.rpn import rotated_iou_loss
from nerf_rpn_tpu_torch.ops.aabb import clip_boxes_to_grid, small_box_mask
from nerf_rpn_tpu_torch.ops.fcos_box import (
    decode_fcos_aabb,
    decode_fcos_obb,
    encode_fcos_aabb,
    encode_fcos_obb,
)
from nerf_rpn_tpu_torch.ops.nms import NEG_INF, nms_mask
from nerf_rpn_tpu_torch.ops.obb import obb2points_3d
from nerf_rpn_tpu_torch.ops.rotated_iou import box2corners
from nerf_rpn_tpu_torch.ops.topk import safe_top_k
from nerf_rpn_tpu_torch.parallel import ddp
from nerf_rpn_tpu_torch.utils.losses import bce_with_logits, sigmoid_focal_loss, smooth_l1
from nerf_rpn_tpu_torch.utils.projection import project_points

INF = 1e8
SIZES_OF_INTEREST = ((-1.0, 16.0), (16.0, 32.0), (32.0, 64.0), (64.0, INF))
IOU_LOSS_TYPES = ("iou", "linear_iou", "giou", "diou", "smooth_l1")
# positives gathered per gt box for the box and centerness losses
POSITIVES_PER_GT = 128


@dataclasses.dataclass(frozen=True)
class FCOSConfig:
    """Defaults = the reference driver's defaults."""

    rotated: bool = False
    fpn_strides: tuple = (4, 8, 16, 32)
    center_sampling_radius: float = 1.5
    iou_loss_type: str = "iou"
    norm_reg_targets: bool = True
    use_additional_l1_loss: bool = False
    proj2d_loss_weight: float = 0.0
    pre_nms_thresh: float = 0.0
    pre_nms_top_n: int = 2500
    nms_thresh: float = 0.3
    fpn_post_nms_top_n: int = 2500
    min_size: float = 0.0

    def __post_init__(self):
        if self.iou_loss_type not in IOU_LOSS_TYPES:
            raise ValueError(f"unknown iou_loss_type {self.iou_loss_type!r}")
        if self.iou_loss_type == "diou" and not self.rotated:
            # the JAX package's AABB IoU loss raises for it as well
            raise NotImplementedError("iou_loss_type 'diou' is a rotated loss: it needs OBBs")

    @property
    def reg_dim(self) -> int:
        return 8 if self.rotated else 6


# ---------------------------------------------------------------------------
# Location tables
# ---------------------------------------------------------------------------


def fcos_locations(level_shapes: Sequence[Sequence[int]], strides: Sequence[int]):
    """Voxel-centre locations per level, ``stride * i + stride // 2``.

    Returns numpy (locations (L, 3) f32, level_of_loc (L,) i32, counts,
    stride_of_loc (L,) f32, soi (L, 2) f32).
    """
    locs, level_ids, counts = [], [], []
    for lvl, (shape, stride) in enumerate(zip(level_shapes, strides)):
        ax = [np.arange(s, dtype=np.float32) * stride + stride // 2 for s in shape]
        pts = np.stack(np.meshgrid(*ax, indexing="ij"), axis=-1).reshape(-1, 3)
        locs.append(pts)
        counts.append(pts.shape[0])
        level_ids.append(np.full(pts.shape[0], lvl, np.int32))
    locations = np.concatenate(locs, 0)
    level_of_loc = np.concatenate(level_ids, 0)
    stride_of_loc = np.asarray(strides, np.float32)[level_of_loc]
    soi = np.asarray(SIZES_OF_INTEREST, np.float32)[
        np.clip(level_of_loc, 0, len(SIZES_OF_INTEREST) - 1)]
    return locations, level_of_loc, counts, stride_of_loc, soi


def flatten_fcos_outputs(per_level: Sequence[torch.Tensor], ch: int) -> torch.Tensor:
    """Per-level (B, X, Y, Z, C) -> (B, L, C), (x, y, z) order."""
    b = per_level[0].shape[0]
    return torch.cat([p.reshape(b, -1, ch) for p in per_level], dim=1)


def fcos_padding_mask(locations: torch.Tensor, ori_sizes: torch.Tensor) -> torch.Tensor:
    """(B, L) True where the location lies inside the scene's original size."""
    return torch.all(locations[None] < ori_sizes[:, None, :], dim=-1)


# ---------------------------------------------------------------------------
# Target assignment
# ---------------------------------------------------------------------------


def _sample_region_mask(aabbs: torch.Tensor, locations: torch.Tensor,
                        stride_of_loc: torch.Tensor, radius: float) -> torch.Tensor:
    """(L, G) center-sampling mask: the location lies within radius x
    stride of the gt's centre, clamped into the gt box."""
    ctr = (aabbs[:, 0:3] + aabbs[:, 3:6]) / 2
    r = (stride_of_loc * radius)[:, None, None]
    lo = torch.maximum(ctr[None] - r, aabbs[None, :, 0:3])
    hi = torch.minimum(ctr[None] + r, aabbs[None, :, 3:6])
    near = locations[:, None, :] - lo
    far = hi - locations[:, None, :]
    return torch.cat([near, far], dim=-1).amin(dim=-1) > 0


def fcos_targets_single(cfg: FCOSConfig, locations: torch.Tensor,
                        stride_of_loc: torch.Tensor, soi: torch.Tensor,
                        gt: torch.Tensor, gt_mask: torch.Tensor):
    """One scene: labels (L,) f32 and box targets (L, 6|8) of the (G, 6|7)
    gt boxes under ``gt_mask`` (G,)."""
    n_loc, n_gt = locations.shape[0], gt.shape[0]
    if cfg.rotated:
        reg_all = encode_fcos_obb(locations[:, None, :].expand(n_loc, n_gt, 3),
                                  gt[None].expand(n_loc, *gt.shape))  # (L, G, 8)
        corners = box2corners(torch.cat([gt[:, 0:2], gt[:, 3:5], gt[:, 6:7]], dim=-1))
        aabbs = torch.cat([corners.amin(dim=1), gt[:, 2:3] - gt[:, 5:6] / 2,
                           corners.amax(dim=1), gt[:, 2:3] + gt[:, 5:6] / 2], dim=1)
    else:
        reg_all = encode_fcos_aabb(locations[:, None, :], gt[None])  # (L, G, 6)
        aabbs = gt

    if cfg.center_sampling_radius > 0:
        in_boxes = _sample_region_mask(aabbs, locations, stride_of_loc,
                                       cfg.center_sampling_radius)
    else:
        in_boxes = reg_all[..., :6].amin(dim=-1) > 0

    max_reg = reg_all[..., :6].amax(dim=-1)
    cared = (max_reg >= soi[:, 0:1]) & (max_reg <= soi[:, 1:2])
    volumes = torch.prod(aabbs[:, 3:6] - aabbs[:, 0:3], dim=-1)
    area = torch.where(in_boxes & cared & gt_mask[None], volumes[None], INF)
    labels = (area.amin(dim=1) < INF).float()
    gt_idx = torch.argmin(area, dim=1)  # the first least volume on ties
    reg = torch.gather(reg_all, 1, gt_idx[:, None, None].expand(n_loc, 1,
                                                                 reg_all.shape[-1]))[:, 0]
    if cfg.norm_reg_targets:
        # the distances in units of the level's stride (a power of two,
        # so the reciprocal is exact); the midpoint offsets as they are
        scaled = torch.arange(reg.shape[-1], device=reg.device) < 6
        reg = reg * torch.where(scaled[None, :], 1.0 / stride_of_loc[:, None], 1.0)
    return labels, reg


def fcos_targets(cfg: FCOSConfig, locations, stride_of_loc, soi, gt, gt_mask):
    """Batched :func:`fcos_targets_single`: labels (B, L), targets (B, L, D)."""
    out = [fcos_targets_single(cfg, locations, stride_of_loc, soi, g, m)
           for g, m in zip(gt, gt_mask)]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def iou_loss_aabb_ref(pred: torch.Tensor, target: torch.Tensor, loss_type: str) -> torch.Tensor:
    """The reference ``IOULoss`` on distance-encoded AABBs: the
    (+1)-smoothed IoU; giou with the 1e-7-stabilised enclosing box."""
    pv = torch.prod(pred[..., 0:3] + pred[..., 3:6], dim=-1)
    tv = torch.prod(target[..., 0:3] + target[..., 3:6], dim=-1)
    inter_dims = (torch.minimum(pred[..., 0:3], target[..., 0:3])
                  + torch.minimum(pred[..., 3:6], target[..., 3:6]))
    inter = torch.prod(inter_dims, dim=-1)
    union = pv + tv - inter
    ious = (inter + 1.0) / (union + 1.0)
    if loss_type == "iou":
        return -torch.log(ious)
    if loss_type == "linear_iou":
        return 1.0 - ious
    if loss_type == "giou":
        enc_dims = (torch.maximum(pred[..., 0:3], target[..., 0:3])
                    + torch.maximum(pred[..., 3:6], target[..., 3:6]))
        enc = torch.prod(enc_dims, dim=-1) + 1e-7
        return 1.0 - (ious - (enc - union) / enc)
    raise NotImplementedError(loss_type)


def rotated_loss_from_reg(pred: torch.Tensor, target: torch.Tensor,
                          loss_type: str) -> torch.Tensor:
    """The reference FCOS ``RotatedIOULoss``: both box vectors decoded at a
    dummy origin, then the rotated IoU loss."""
    dummy = torch.zeros(pred.shape[:-1] + (3,), dtype=pred.dtype, device=pred.device)
    return rotated_iou_loss(decode_fcos_obb(dummy, pred), decode_fcos_obb(dummy, target),
                            loss_type)


def compute_centerness_targets(reg: torch.Tensor) -> torch.Tensor:
    """sqrt of the product over the axes of min / max distance; clipped at
    0 first (negative distances of non-positive locations)."""
    c = None
    for a, b in ((0, 3), (1, 4), (2, 5)):
        lo = torch.minimum(reg[..., a], reg[..., b])
        hi = torch.maximum(reg[..., a], reg[..., b])
        c = lo / hi if c is None else c * (lo / hi)
    return torch.sqrt(c.clamp_min(0.0))


def fcos_losses(cfg: FCOSConfig, cls_logits: torch.Tensor, box_reg: torch.Tensor,
                centerness: torch.Tensor, locations: torch.Tensor,
                stride_of_loc: torch.Tensor, soi: torch.Tensor, gt: torch.Tensor,
                gt_mask: torch.Tensor,
                padding_mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """``loss_cls``, ``loss_reg`` and ``loss_centerness`` of (B, L, 1),
    (B, L, 6|8) and (B, L, 1) head outputs against (B, G, 6|7) gt boxes,
    plus ``dropped_positives``: the positives beyond the gather capacity K,
    summed over the batch (0 where K holds them all).  ``num_pos_avg`` and
    ``sum_ctr_avg`` are the global batch's under a process group (summed
    over the ranks, then clamped)."""
    b, l_total = cls_logits.shape[:2]
    with torch.no_grad():
        labels, reg_targets = fcos_targets(cfg, locations, stride_of_loc, soi, gt, gt_mask)
    valid = (padding_mask if padding_mask is not None
             else torch.ones((b, l_total), dtype=torch.bool, device=cls_logits.device))
    pos = (labels > 0) & valid
    n_pos = pos.float().sum()

    # the box and centerness losses read only the positive locations:
    # gather them to K = min(L, 128 G) rows a scene, the positives first in
    # index order (the order of lax.top_k on the 0/1 vector); radius 0
    # keeps the dense form
    k_pos = min(l_total, POSITIVES_PER_GT * gt.shape[1]) if cfg.center_sampling_radius > 0 else 0
    dropped = torch.zeros((), device=cls_logits.device)
    if 0 < k_pos < l_total:
        _, idx = safe_top_k(pos.float(), k_pos)
        n_all = pos.sum()
        pos = torch.gather(pos, 1, idx)
        dropped = (n_all - pos.sum()).float()
        box_reg = torch.gather(box_reg, 1, idx[..., None].expand(-1, -1, box_reg.shape[-1]))
        reg_targets = torch.gather(reg_targets, 1,
                                   idx[..., None].expand(-1, -1, reg_targets.shape[-1]))
        centerness = torch.gather(centerness, 1, idx[..., None])

    ctr_targets = torch.where(pos, compute_centerness_targets(reg_targets), 0.0)
    # the normalisers of the global batch under a process group
    n_pos, ctr_sum = ddp.all_reduce_sum(n_pos, ctr_targets.sum())
    num_pos_avg = n_pos.clamp_min(1.0)
    sum_ctr_avg = ctr_sum.clamp_min(1e-6)
    cls_loss = torch.sum(sigmoid_focal_loss(cls_logits[..., 0], labels) * valid) / num_pos_avg
    posf = pos.float()
    # non-positive rows take a safe row before the loss: masked out of the
    # sums, but -log or a decode of garbage would give NaNs that survive a
    # product with 0.  The OBB row must decode to a box that is not
    # degenerate (offsets +1 collapse a side), hence 0.25 / -0.25.
    if cfg.rotated:
        safe_row = torch.tensor([1, 1, 1, 1, 1, 1, 0.25, -0.25], dtype=box_reg.dtype,
                                device=box_reg.device)
    else:
        safe_row = torch.ones((6,), dtype=box_reg.dtype, device=box_reg.device)
    safe_pred = torch.where(pos[..., None], box_reg, safe_row)
    safe_tgt = torch.where(pos[..., None], reg_targets, safe_row)
    weight = ctr_targets * posf
    if cfg.iou_loss_type == "smooth_l1":
        per = smooth_l1(safe_pred, safe_tgt, beta=1.0)
        reg_loss = torch.sum(per * weight[..., None]) / sum_ctr_avg
    elif cfg.rotated:
        per = rotated_loss_from_reg(safe_pred, safe_tgt, cfg.iou_loss_type)
        reg_loss = torch.sum(per * weight) / sum_ctr_avg
    else:
        per = iou_loss_aabb_ref(safe_pred, safe_tgt, cfg.iou_loss_type)
        reg_loss = torch.sum(per * weight) / sum_ctr_avg

    if cfg.rotated and cfg.use_additional_l1_loss and cfg.iou_loss_type != "smooth_l1":
        extra = smooth_l1(safe_pred[..., 6:], safe_tgt[..., 6:], beta=1.0)
        reg_loss = reg_loss + torch.sum(extra * weight[..., None]) / sum_ctr_avg

    if cfg.rotated and cfg.proj2d_loss_weight > 0:
        dummy = torch.zeros(safe_pred.shape[:-1] + (3,), dtype=safe_pred.dtype,
                            device=safe_pred.device)
        pred_uv = project_points(obb2points_3d(decode_fcos_obb(dummy, safe_pred)), 160)
        tgt_uv = project_points(obb2points_3d(decode_fcos_obb(dummy, safe_tgt)), 160)
        l2d = smooth_l1(pred_uv, tgt_uv, beta=1.0 / 9) / 160.0
        # the reference: sum(loss * w) / (factor * 2), factor = 8 point rows
        proj2d = torch.sum(l2d * weight[..., None, None, None]) / (8.0 * 2.0) / sum_ctr_avg
        reg_loss = reg_loss + proj2d * cfg.proj2d_loss_weight

    ctr_loss = torch.sum(bce_with_logits(centerness[..., 0], ctr_targets) * posf) / num_pos_avg
    return {"loss_cls": cls_loss, "loss_reg": reg_loss, "loss_centerness": ctr_loss,
            "dropped_positives": dropped}


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------


def fcos_inference(cfg: FCOSConfig, cls_logits: torch.Tensor, box_reg: torch.Tensor,
                   centerness: torch.Tensor, locations: torch.Tensor,
                   level_counts: Sequence[int], ori_sizes: torch.Tensor,
                   padding_mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """Fixed-capacity FCOS proposals from (B, L, 1), (B, L, 6|8) (distances
    already multiplied by the stride in the head) and (B, L, 1) outputs.

    Returns boxes (B, K, 6|7), scores (B, K), level_idx (B, K) and valid
    (B, K), K = ``fpn_post_nms_top_n``: score-sorted, masked entries last
    with score 0.
    """
    b = cls_logits.shape[0]
    scores = torch.sigmoid(cls_logits[..., 0])
    if padding_mask is not None:
        scores = torch.where(padding_mask, scores, -1e5)
    combined = scores * torch.sigmoid(centerness[..., 0])

    boxes_l, scores_l, valid_l, levels_l = [], [], [], []
    offset = 0
    for lvl, count in enumerate(level_counts):
        k = min(cfg.pre_nms_top_n, count)
        s = scores[:, offset:offset + count]
        masked = torch.where(s > cfg.pre_nms_thresh, combined[:, offset:offset + count],
                             NEG_INF)
        top_s, top_i = safe_top_k(masked, k)
        reg = box_reg[:, offset:offset + count]
        sel_reg = torch.gather(reg, 1, top_i[..., None].expand(-1, -1, reg.shape[-1]))
        sel_loc = locations[offset:offset + count][top_i]
        if cfg.rotated:
            det = decode_fcos_obb(sel_loc, sel_reg)
        else:
            det = clip_boxes_to_grid(decode_fcos_aabb(sel_loc, sel_reg),
                                     ori_sizes[:, None, :].to(sel_reg.dtype))
        boxes_l.append(det)
        scores_l.append(torch.sqrt(top_s.clamp_min(0.0)))
        valid_l.append((top_s > NEG_INF / 2) & small_box_mask(det, cfg.min_size))
        levels_l.append(torch.full((b, k), lvl, dtype=torch.int32, device=det.device))
        offset += count

    boxes = torch.cat(boxes_l, 1)
    scs = torch.cat(scores_l, 1)
    valid = torch.cat(valid_l, 1)
    levels = torch.cat(levels_l, 1)
    # cross-level, single-class NMS: one problem per scene
    keep = nms_mask(boxes, scs, valid, cfg.nms_thresh)
    top_s, top_i = safe_top_k(torch.where(keep, scs, NEG_INF), cfg.fpn_post_nms_top_n)
    return {
        "boxes": torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, boxes.shape[-1])),
        "scores": top_s.clamp_min(0.0),
        "level_idx": torch.gather(levels, 1, top_i),
        "valid": top_s > NEG_INF / 2,
    }


def fcos_voxel_scores(cls_logits: Sequence[torch.Tensor],
                      centerness: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Per-level sqrt(sigmoid(cls) x sigmoid(ctr)) volumes (B, X, Y, Z)."""
    return [torch.sqrt(torch.sigmoid(c[..., 0]) * torch.sigmoid(t[..., 0]))
            for c, t in zip(cls_logits, centerness)]
