"""FCOS box parameterisation (port of ``nerf_rpn_tpu/ops/fcos_box.py``).

- AABBs: 6 distances ``[l, t, f, r, b, ba]`` from a location to the box's
  faces (``encode_fcos_aabb`` / ``decode_fcos_aabb``).
- OBBs: the 6 distances to the OBB's enclosing AABB plus the normalised
  offsets (alpha, beta) of the midpoints of its bottom and right edges
  (``encode_fcos_obb``), falling back to the AABB corner where theta is
  too small to be stable (0.1 tolerance); ``decode_fcos_obb`` rebuilds the
  two vertices, scales both to the longer diagonal and recovers (w, l,
  theta), with ``safe_norm``'s 1e-20 keeping the gradient finite at
  degenerate regressions.

Elementwise over leading dims: location i pairs with box i.
"""

from __future__ import annotations

import torch

from nerf_rpn_tpu_torch.ops.rotated_iou import box2corners


def encode_fcos_aabb(locations: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(..., 3) locations x (..., 6) AABBs -> (..., 6) distances."""
    return torch.cat([locations - boxes[..., 0:3], boxes[..., 3:6] - locations], dim=-1)


def decode_fcos_aabb(locations: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """(..., 3) locations + (..., 6) distances -> (..., 6) AABBs."""
    return torch.cat([locations - reg[..., 0:3], locations + reg[..., 3:6]], dim=-1)


def encode_fcos_obb(locations: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(..., 3) locations x (..., 7) OBBs -> (..., 8) targets
    ``[x0, y0, z0, x1, y1, z1, alpha, beta]``."""
    proj = torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]], dim=-1)
    corners = box2corners(proj)
    xs, ys = corners[..., 0], corners[..., 1]
    xmax, ymax = xs.amax(-1), ys.amax(-1)
    xmin, ymin = xs.amin(-1), ys.amin(-1)

    x0 = locations[..., 0] - xmin
    y0 = locations[..., 1] - ymin
    z0 = locations[..., 2] - (boxes[..., 2] - boxes[..., 5] / 2)
    x1 = xmax - locations[..., 0]
    y1 = ymax - locations[..., 1]
    z1 = (boxes[..., 2] + boxes[..., 5] / 2) - locations[..., 2]

    # the x of the corner on the top edge (y == ymax) and the y of the
    # corner on the right edge (x == xmax), 0.1 tolerance
    vx = torch.where(ymax[..., None] - ys > 0.1, -1e6, xs).amax(-1)
    vy = torch.where(xmax[..., None] - xs > 0.1, 1e6, ys).amin(-1)
    # near axis-aligned: the AABB corner
    degen = torch.isclose(vx, xmax) & torch.isclose(vy, ymin)
    vx = torch.where(degen, xmax, vx)
    vy = torch.where(degen, ymin, vy)

    alpha = (vx - boxes[..., 0]) / (xmax - xmin)
    beta = (vy - boxes[..., 1]) / (ymax - ymin)
    return torch.stack([x0, y0, z0, x1, y1, z1, alpha, beta], dim=-1)


def _safe_norm(v: torch.Tensor) -> torch.Tensor:
    """sqrt has an infinite gradient at 0: an untrained head's negative
    distances give zero-length vectors here, and the 1e-20 shift (far
    below f32 resolution for any real box) keeps their gradient finite."""
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-20)


def decode_fcos_obb(locations: torch.Tensor, reg: torch.Tensor,
                    eps: float = 1e-7) -> torch.Tensor:
    """(..., 3) locations + (..., 8) targets -> (..., 7) OBBs."""
    x0 = locations[..., 0] - reg[..., 0]
    y0 = locations[..., 1] - reg[..., 1]
    z0 = locations[..., 2] - reg[..., 2]
    x1 = locations[..., 0] + reg[..., 3]
    y1 = locations[..., 1] + reg[..., 4]
    z1 = locations[..., 2] + reg[..., 5]
    vx = torch.clamp((x1 + x0) / 2 + reg[..., 6] * (x1 - x0), x0, x1)
    vy = torch.clamp((y1 + y0) / 2 + reg[..., 7] * (y1 - y0), y0, y1)
    cx, cy, cz = (x0 + x1) / 2, (y0 + y1) / 2, (z0 + z1) / 2

    v0 = torch.stack([vx - cx, y1 - cy], dim=-1)
    v1 = torch.stack([x1 - cx, vy - cy], dim=-1)
    d0, d1 = _safe_norm(v0), _safe_norm(v1)
    dmax = torch.maximum(d0, d1)
    v0 = v0 / (d0[..., None] + eps) * dmax[..., None]
    v1 = v1 / (d1[..., None] + eps) * dmax[..., None]

    l = _safe_norm(v0 - v1)
    mid = (v0 + v1) / 2
    w = _safe_norm(mid) * 2
    h = z1 - z0
    mid_x = torch.where((mid[..., 0] == 0) & (mid[..., 1] == 0), eps, mid[..., 0])
    theta = torch.atan2(mid[..., 1], mid_x)
    return torch.stack([cx, cy, cz, w, l, h, theta], dim=-1)
