"""Axis-aligned 3D box algebra (port of ``nerf_rpn_tpu/ops/aabb.py``).

Boxes are ``[x1, y1, z1, x2, y2, z2]``; the two masks also take OBBs
``[x, y, z, w, l, h, theta]``.  Every function returns masks rather than
filtering, like the JAX original.
"""

from __future__ import annotations

import torch


def _prod3(t: torch.Tensor) -> torch.Tensor:
    """Product over the last axis of size 3, in the order (x * y) * z."""
    return t[..., 0] * t[..., 1] * t[..., 2]


def box_volume(boxes: torch.Tensor) -> torch.Tensor:
    """Volume of AABBs. boxes: (..., 6) -> (...)."""
    return _prod3(boxes[..., 3:6] - boxes[..., 0:3])


def box_iou_aabb(boxes1: torch.Tensor, boxes2: torch.Tensor,
                 eps: float = 0.0) -> torch.Tensor:
    """Elementwise IoU between aligned AABB sets: (..., 6) x (..., 6) -> (...)."""
    lt = torch.maximum(boxes1[..., 0:3], boxes2[..., 0:3])
    rb = torch.minimum(boxes1[..., 3:6], boxes2[..., 3:6])
    inter = _prod3((rb - lt).clamp_min(0.0))
    union = box_volume(boxes1) + box_volume(boxes2) - inter
    return inter / (union + eps) if eps else inter / union


def pairwise_iou_aabb(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU matrix: (M, 6) x (N, 6) -> (M, N)."""
    return box_iou_aabb(boxes1[:, None, :], boxes2[None, :, :])


def clip_boxes_to_grid(boxes: torch.Tensor, grid_size: torch.Tensor) -> torch.Tensor:
    """Clamp AABBs into ``[0, grid_size]`` per axis; ``grid_size`` (..., 3)."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    lo = torch.minimum(torch.maximum(boxes[..., 0:3], zero), grid_size)
    hi = torch.minimum(torch.maximum(boxes[..., 3:6], zero), grid_size)
    return torch.cat([lo, hi], dim=-1)


def obb_center_valid_mask(boxes: torch.Tensor, grid_size: torch.Tensor) -> torch.Tensor:
    """True where the OBB's centre lies inside ``[0, grid_size]``: OBBs
    cannot be clamped, so proposals whose centre leaves the grid are
    dropped instead.  boxes (..., 7); grid_size (..., 3)."""
    ctr = boxes[..., 0:3]
    return torch.all((ctr >= 0.0) & (ctr <= grid_size), dim=-1)


def small_box_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """True where the box has every side >= min_size: AABB (..., 6), or OBB
    (..., 7) with its sizes (w, l, h) at 3:6."""
    dims = boxes[..., 3:6] - boxes[..., 0:3] if boxes.shape[-1] == 6 else boxes[..., 3:6]
    return torch.all(dims >= min_size, dim=-1)
