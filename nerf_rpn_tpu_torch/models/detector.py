"""RCNN second stage: RoI sampling, the pooled-feature head, its losses and
the eval-time filter (port of ``nerf_rpn_tpu/models/detector.py``).

- ``sample_rois``: match RoIs to gt by IoU (OBBs by their enclosing AABBs),
  take foreground (max IoU >= ``fg_threshold``) up to ``fg_fraction`` of
  the budget in a random order, fill the rest with background (max IoU <
  ``bg_threshold``), cycling through a scarce pool -- sampling with
  replacement, the reference's random-index fill -- and with foreground
  everywhere when there is no background.  Batched over scenes; the
  random priorities come from a ``torch.Generator`` (``indices`` replaces
  the draw, for tests that feed the JAX package's sample);
- ``label_all_rois``: the label and matched gt of every RoI (eval);
- ``RCNNHead``: an optional tower of 2 x (3^3 conv + ReLU), then flatten
  or mean, then the box deltas (6, or 7 with ``rotated``) and the class
  scores.  It takes the pooled features channels last, (R, ox, oy, oz, C),
  so the flattened Dense input is in flax's (ox, oy, oz, C) order and a
  flax kernel maps on by a transpose alone.  Torch names: ``conv_0``,
  ``conv_1``, ``bbox_pred``, ``cls_score`` (the flax module names);
- ``rcnn_losses``: cross-entropy over the valid rows plus smooth-L1 (beta
  1/9) over the foreground rows divided by their count, non-foreground rows
  encoded against themselves (``safe_gt``) so that none encodes log(0);
- ``filter_refined_proposals``: clip (AABB) or the centre-valid mask
  (OBB), small boxes, the score threshold, NMS (K3 and the resolve kernel
  for AABBs, the rotated graph and the resolve kernel for OBBs), the
  score-descending order and the ``num_threshold`` cap.

``RCNNDetector`` holds the head and, for ``--fine_tune``, the backbone.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nerf_rpn_tpu_torch.models.layers import conv3d, dense
from nerf_rpn_tpu_torch.ops import coders
from nerf_rpn_tpu_torch.ops.aabb import (box_iou_aabb, clip_boxes_to_grid,
                                         obb_center_valid_mask, small_box_mask)
from nerf_rpn_tpu_torch.ops.nms import nms_mask
from nerf_rpn_tpu_torch.ops.obb import obb2hbb_3d
from nerf_rpn_tpu_torch.parallel import ddp
from nerf_rpn_tpu_torch.utils.losses import smooth_l1


@dataclasses.dataclass(frozen=True)
class RCNNConfig:
    """Defaults = the reference driver's (``run_rpn_detect.py:108-133``)."""

    rotated: bool = False
    batch_size: int = 1000         # sampled RoIs per batch
    fg_fraction: float = 0.5
    fg_threshold: float = 0.35
    bg_threshold: float = 0.15
    output_size: tuple = (4, 4, 4)
    enlarge_scale: float = 0.2
    sampling_ratio: int = 2
    pool_mode: str = "avg"         # 'avg' (align) | 'max' (pooling)
    remap_levels: bool = False
    canonical_scale: int = 160
    canonical_level: int = 4

    @property
    def box_dim(self) -> int:
        return 7 if self.rotated else 6

    def encode(self, gt, rois):
        return coders.encode_rotated(gt, rois) if self.rotated else coders.encode_aabb(gt, rois)

    def decode(self, deltas, rois):
        if self.rotated:
            return coders.decode_rotated(deltas, rois)
        return coders.decode_aabb(deltas, rois)


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, N, ...) at idx (B, K) -> (B, K, ...)."""
    return t[torch.arange(t.shape[0], device=t.device)[:, None], idx]


def match_rois_to_gt(cfg: RCNNConfig, rois: torch.Tensor, roi_valid: torch.Tensor,
                     gt: torch.Tensor, gt_mask: torch.Tensor):
    """IoU matching per scene: rois (B, R, D), gt (B, G, D) -> (max_iou (B,
    R), assignment (B, R)); masked gt and invalid RoIs score -1, and the
    first index wins a tie."""
    if cfg.rotated:
        rois, gt = obb2hbb_3d(rois), obb2hbb_3d(gt)
    iou = box_iou_aabb(rois[..., :, None, :], gt[..., None, :, :])
    iou = torch.where(gt_mask[..., None, :], iou, -1.0)
    iou = torch.where(roi_valid[..., :, None], iou, -1.0)
    return iou.max(dim=-1)


def sample_rois(cfg: RCNNConfig, generator: torch.Generator | None, rois: torch.Tensor,
                roi_levels: torch.Tensor, roi_valid: torch.Tensor, gt: torch.Tensor,
                gt_mask: torch.Tensor, rois_per_image: int,
                indices: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """Fixed-size fg/bg RoI sampling, batched over scenes: rois (B, R, D),
    roi_levels / roi_valid (B, R), gt (B, G, D), gt_mask (B, G).  Returns
    (B, ``rois_per_image``)-shaped ``boxes``, ``levels``, ``labels`` (1 fg
    / 0 bg, float), ``matched_gt``, ``valid`` and ``indices``.

    ``indices`` (B, ``rois_per_image``) replaces the random draw; the
    labels and validity follow from the counts, as in JAX.
    """
    max_iou, assign = match_rois_to_gt(cfg, rois, roi_valid, gt, gt_mask)
    is_fg = (max_iou >= cfg.fg_threshold) & roi_valid
    is_bg = (max_iou < cfg.bg_threshold) & roi_valid
    n_fg_avail = is_fg.sum(-1, keepdim=True)
    n_bg_avail = is_bg.sum(-1, keepdim=True)
    fg_budget = max(int(round(cfg.fg_fraction * rois_per_image)), 1)
    # no background -> every slot foreground (reference detector.py:120)
    n_fg = torch.where(n_bg_avail == 0, n_fg_avail.clamp(max=rois_per_image),
                       n_fg_avail.clamp(max=fg_budget))
    slots = torch.arange(rois_per_image, device=rois.device)
    take_fg = slots < n_fg
    if indices is None:
        # random-priority compaction: each pool's indices first, in a
        # random order; slots cycle within a scarce pool
        u = torch.rand((2, *is_fg.shape), generator=generator, device=rois.device)
        fg_order = torch.sort(torch.where(is_fg, u[0], math.inf), dim=-1, stable=True).indices
        bg_order = torch.sort(torch.where(is_bg, u[1], math.inf), dim=-1, stable=True).indices
        fg_slot = slots % n_fg_avail.clamp(min=1)
        bg_slot = (slots - n_fg) % n_bg_avail.clamp(min=1)
        indices = torch.where(take_fg, torch.gather(fg_order, -1, fg_slot),
                              torch.gather(bg_order, -1, bg_slot))
    valid = torch.where(take_fg, n_fg_avail > 0, n_bg_avail > 0)
    return {
        "boxes": _gather_rows(rois, indices),
        "levels": torch.gather(roi_levels, -1, indices),
        "labels": (take_fg & valid).float(),
        "matched_gt": _gather_rows(gt, torch.gather(assign, -1, indices).clamp(min=0)),
        "valid": valid,
        "indices": indices,
    }


def label_all_rois(cfg: RCNNConfig, rois, roi_valid, gt, gt_mask):
    """Non-sampling path: the binary label and matched gt of every RoI,
    batched as :func:`sample_rois` (reference ``detector.py:150-166``)."""
    max_iou, assign = match_rois_to_gt(cfg, rois, roi_valid, gt, gt_mask)
    labels = ((max_iou >= cfg.fg_threshold) & roi_valid).float()
    return labels, _gather_rows(gt, assign.clamp(min=0))


class RCNNHead(nn.Module):
    """Pooled RoI features (R, ox, oy, oz, C) -> (deltas (R, 6|7), scores
    (R, n_classes)), in ``dtype`` with f32 parameters (flax's
    ``dtype`` semantics)."""

    def __init__(self, in_channels: int = 256, n_classes: int = 2, rotated: bool = False,
                 add_conv_layers: bool = False, flatten: bool = True,
                 output_size: Sequence[int] = (4, 4, 4), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.add_conv_layers = add_conv_layers
        self.flatten = flatten
        self.dtype = dtype
        if add_conv_layers:
            self.conv_0 = nn.Conv3d(in_channels, in_channels, 3, padding=1)
            self.conv_1 = nn.Conv3d(in_channels, in_channels, 3, padding=1)
        n_in = in_channels * math.prod(output_size) if flatten else in_channels
        self.bbox_pred = nn.Linear(n_in, 7 if rotated else 6)
        self.cls_score = nn.Linear(n_in, n_classes)

    def forward(self, x: torch.Tensor):
        if self.add_conv_layers:
            for conv in (self.conv_0, self.conv_1):
                x = torch.relu(conv3d(x, conv, self.dtype))
        x = x.reshape(x.shape[0], -1) if self.flatten else x.mean(dim=(1, 2, 3))
        return dense(x, self.bbox_pred, self.dtype), dense(x, self.cls_score, self.dtype)


class RCNNDetector(nn.Module):
    """The second stage: ``head`` and, for ``--fine_tune``, the ``backbone``
    that makes the FPN levels from raw grids (else None: the levels come
    from ``run_rpn --save_results`` files)."""

    def __init__(self, head: RCNNHead, backbone: nn.Module | None = None):
        super().__init__()
        self.backbone = backbone
        self.head = head


def rcnn_losses(cfg: RCNNConfig, pred_deltas: torch.Tensor, pred_scores: torch.Tensor,
                labels: torch.Tensor, matched_gt: torch.Tensor, rois: torch.Tensor,
                valid: torch.Tensor, over_world: bool = False) -> dict[str, torch.Tensor]:
    """CE objectness over the valid rows + smooth-L1 on the foreground
    deltas over their count (reference ``compute_loss``,
    ``detector.py:536-559``); rows (N, .).  Under a process group both
    counts, and the switch on the foreground count, are the global
    batch's: summed over the data group's ranks, or with ``over_world``
    (the space axis, where each rank of a space group holds its own block
    of a scene's rows) over every rank."""
    logp = F.log_softmax(pred_scores, dim=-1)
    ce = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    vf = valid.to(ce.dtype)
    fg = (labels > 0) & valid
    n_valid, n_fg = ddp.all_reduce_sum(torch.sum(vf), torch.sum(fg), over_world=over_world)
    obj_loss = torch.sum(ce * vf) / torch.clamp(n_valid, min=1.0)
    # non-fg rows encode against themselves: a zero gt would give log(0)
    safe_gt = torch.where(fg[:, None], matched_gt, rois)
    reg = smooth_l1(pred_deltas, cfg.encode(safe_gt, rois), beta=1.0 / 9)
    box_loss = torch.where(n_fg > 0, torch.sum(reg * fg[:, None]) / torch.clamp(n_fg, min=1),
                           0.0)
    return {"loss_objectness": obj_loss, "loss_rpn_box_reg": box_loss}


def filter_refined_proposals(cfg: RCNNConfig, boxes: torch.Tensor, probs: torch.Tensor,
                             valid: torch.Tensor, mesh_size: torch.Tensor,
                             score_threshold: float, nms_threshold: float,
                             num_threshold: int, min_size: float = 1e-3):
    """The stage-2 eval filter of one scene (reference ``filter_proposals``,
    ``run_rpn_detect.py:403-439``): boxes (R, D), probs (R, 2), valid (R,),
    mesh_size (3,) -> (boxes, keep, order).  ``keep`` is the validity after
    NMS and the cap, in the original order; ``order`` ranks the kept rows
    by descending fg score (stable), the others last.

    The JAX package's documented deviations from the reference hold: the
    OBB centre mask applies to the scores too; the score threshold is a row
    mask (either column at or over it); ``num_threshold`` caps the kept
    rows by descending score (the reference reads the flag and never
    applies it)."""
    mesh_size = mesh_size.to(boxes.dtype)
    if cfg.rotated:
        valid = valid & obb_center_valid_mask(boxes, mesh_size)
    else:
        boxes = clip_boxes_to_grid(boxes, mesh_size)
    valid = valid & small_box_mask(boxes, min_size)
    valid = valid & torch.any(probs >= score_threshold, dim=-1)
    fg = probs[:, 1]
    keep = nms_mask(boxes[None, :, :cfg.box_dim], fg[None], valid[None], nms_threshold)[0]
    order = torch.sort(torch.where(keep, -fg, math.inf), stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    return boxes, keep & (rank < num_threshold), order
