"""Rotated 3D IoU of box pairs (port of ``nerf_rpn_tpu/ops/rotated_iou_pairwise.py``).

Boxes are ``[x, y, z, w, l, h, theta]``, theta about +z.  The 2D footprints
are intersected by convex-polygon clipping, then multiplied by the z
overlap:

1. the 4 corners of each footprint, counter-clockwise;
2. candidate vertices: the corners of each box inside the other (a
   projection test with relative tolerance ``_CONTAIN_TOL``) and the 16
   edge-pair intersections -- 24 slots with a validity mask;
3. the valid vertices centred on their mean and sorted by a pseudo-angle
   (monotone in the angle, no atan2) with an index tie-break of ``i *
   1e-6``; invalid slots take ``_INVALID_KEY`` and are then filled with the
   first vertex;
4. the shoelace area of the ring, 0 where fewer than 3 vertices are valid.

The math and its f32 order are the JAX module's; its TPU layout is not: the
4 corners, the 24 candidates and the ring are a trailing tensor axis here,
and one stable ``torch.sort`` replaces the 32-slot bitonic network (the keys
are distinct once the tie-break is added, so both give the same order).
Sums over the ring run slot by slot, in the JAX module's order.

``iou_rotated_3d_upper_bound`` is the cheap exact bound that gates the
clipping in the NMS graph build (``ops/nms.obb_suppression_graph``).
"""

from __future__ import annotations

import torch

EPS = 1e-8
_CONTAIN_TOL = 1e-5  # relative; the reference's 1e-6 drops corners of
# coincident boxes at typical scene coordinates
_INVALID_KEY = 100.0
_SLOTS = 24  # 8 corners + 16 edge intersections


def _corners(x, y, w, h, theta):
    """Corner coordinates ``(cx, cy)``, each (..., 4), counter-clockwise."""
    cos = torch.cos(theta)[..., None]
    sin = torch.sin(theta)[..., None]
    xs = torch.stack([w / 2, -w / 2, -w / 2, w / 2], dim=-1)
    ys = torch.stack([h / 2, h / 2, -h / 2, -h / 2], dim=-1)
    return x[..., None] + xs * cos - ys * sin, y[..., None] + xs * sin + ys * cos


def _containment(px, py, cx, cy):
    """Is each point (px, py) inside the rectangle with corners (cx, cy)?
    Projection onto its edges from corner 0 (to corners 1 and 3)."""
    ax, ay = cx[..., 0:1], cy[..., 0:1]
    abx, aby = cx[..., 1:2] - ax, cy[..., 1:2] - ay
    adx, ady = cx[..., 3:4] - ax, cy[..., 3:4] - ay
    amx, amy = px - ax, py - ay
    r_ab = (abx * amx + aby * amy) / (abx * abx + aby * aby)
    r_ad = (adx * amx + ady * amy) / (adx * adx + ady * ady)
    return ((r_ab > -_CONTAIN_TOL) & (r_ab < 1 + _CONTAIN_TOL)
            & (r_ad > -_CONTAIN_TOL) & (r_ad < 1 + _CONTAIN_TOL))


def _ordered_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis slot by slot, first to last."""
    total = t[..., 0]
    for i in range(1, t.shape[-1]):
        total = total + t[..., i]
    return total


def _intersection_area(cx1, cy1, cx2, cy2):
    """Intersection area of two quads from their corners (..., 4)."""
    ok_corners = torch.cat([_containment(cx1, cy1, cx2, cy2),
                            _containment(cx2, cy2, cx1, cy1)], dim=-1)

    # 16 edge pairs, box 1's edge k (corner k to k+1) major
    x1, y1 = cx1[..., :, None], cy1[..., :, None]
    x2, y2 = cx1.roll(-1, -1)[..., :, None], cy1.roll(-1, -1)[..., :, None]
    x3, y3 = cx2[..., None, :], cy2[..., None, :]
    x4, y4 = cx2.roll(-1, -1)[..., None, :], cy2.roll(-1, -1)[..., None, :]
    num = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    den_t = (x1 - x3) * (y3 - y4) - (y1 - y3) * (x3 - x4)
    den_u = (x1 - x2) * (y1 - y3) - (y1 - y2) * (x1 - x3)
    parallel = num == 0.0
    safe = torch.where(parallel, 1.0, num)
    t_ex = torch.where(parallel, -1.0, den_t / safe)
    u_ex = torch.where(parallel, -1.0, -den_u / safe)
    ok_edges = (t_ex > 0.0) & (t_ex < 1.0) & (u_ex > 0.0) & (u_ex < 1.0)
    t = den_t / (num + EPS)
    okf = ok_edges.to(x1.dtype)
    ix = ((x1 + t * (x2 - x1)) * okf).flatten(-2)
    iy = ((y1 + t * (y2 - y1)) * okf).flatten(-2)

    shape = torch.broadcast_shapes(cx1.shape, cx2.shape)
    vx = torch.cat([cx1.expand(shape), cx2.expand(shape), ix], dim=-1)
    vy = torch.cat([cy1.expand(shape), cy2.expand(shape), iy], dim=-1)
    ok = torch.cat([ok_corners, ok_edges.flatten(-2)], dim=-1)

    # masked centroid
    count = _ordered_sum(ok.to(vx.dtype))
    denom = count.clamp_min(1.0)
    zero = torch.zeros((), dtype=vx.dtype, device=vx.device)
    mx = _ordered_sum(torch.where(ok, vx, zero)) / denom
    my = _ordered_sum(torch.where(ok, vy, zero)) / denom

    # pseudo-angle keys: 1 - x/(|x|+|y|) for y >= 0 else 3 + x/(|x|+|y|),
    # monotone in the angle over [0, 4)
    dx = vx - mx[..., None]
    dy = vy - my[..., None]
    r = dx / (torch.abs(dx) + torch.abs(dy) + 1e-20)
    pseudo = torch.where(dy >= 0, 1.0 - r, 3.0 + r)
    tie = (torch.arange(_SLOTS, dtype=torch.float64, device=vx.device) * 1e-6).to(vx.dtype)
    keys = torch.where(ok, pseudo, _INVALID_KEY) + tie
    keys, order = torch.sort(keys, dim=-1, stable=True)
    rx = torch.gather(dx, -1, order)
    ry = torch.gather(dy, -1, order)
    filled = keys < _INVALID_KEY / 2
    rx = torch.where(filled, rx, rx[..., 0:1])
    ry = torch.where(filled, ry, ry[..., 0:1])
    nx, ny = rx.roll(-1, -1), ry.roll(-1, -1)
    area = torch.abs(_ordered_sum(rx * ny - ry * nx)) / 2
    return torch.where(count >= 3, area, zero)


def _iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Broadcast (..., 7) x (..., 7) -> (...) rotated 3D IoU."""
    cx1, cy1 = _corners(boxes1[..., 0], boxes1[..., 1], boxes1[..., 3], boxes1[..., 4],
                        boxes1[..., 6])
    cx2, cy2 = _corners(boxes2[..., 0], boxes2[..., 1], boxes2[..., 3], boxes2[..., 4],
                        boxes2[..., 6])
    inter_2d = _intersection_area(cx1, cy1, cx2, cy2)
    zmin1 = boxes1[..., 2] - boxes1[..., 5] * 0.5
    zmax1 = boxes1[..., 2] + boxes1[..., 5] * 0.5
    zmin2 = boxes2[..., 2] - boxes2[..., 5] * 0.5
    zmax2 = boxes2[..., 2] + boxes2[..., 5] * 0.5
    z_overlap = (torch.minimum(zmax1, zmax2) - torch.maximum(zmin1, zmin2)).clamp_min(0.0)
    inter_3d = inter_2d * z_overlap
    v1 = boxes1[..., 3] * boxes1[..., 4] * boxes1[..., 5]
    v2 = boxes2[..., 3] * boxes2[..., 4] * boxes2[..., 5]
    return inter_3d / (v1 + v2 - inter_3d)


def iou_rotated_3d_pairs_soa(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., 7) x (..., 7) -> (...) elementwise rotated 3D IoU."""
    return _iou_3d(boxes1, boxes2)


def pairwise_iou_rotated_3d_soa(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(M, 7) x (N, 7) -> (M, N) rotated 3D IoU."""
    return _iou_3d(boxes1[:, None, :], boxes2[None, :, :])


def iou_rotated_3d_upper_bound(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., M, 7) x (..., N, 7) -> (..., M, N), an exact upper bound on the
    rotated 3D IoU.

    Each OBB lies inside its axis-aligned enclosing box, so the OBB
    intersection volume is at most the enclosing boxes' intersection (and
    either box's volume); IoU = i / (v1 + v2 - i) grows with i, so the
    bounded intersection bounds the IoU.  ~30 operations a pair against
    ~2k for the clipping."""
    def half_extents(b):
        c = torch.abs(torch.cos(b[..., 6]))
        s = torch.abs(torch.sin(b[..., 6]))
        return ((b[..., 3] * c + b[..., 4] * s) * 0.5,
                (b[..., 3] * s + b[..., 4] * c) * 0.5,
                b[..., 5] * 0.5)

    e1 = half_extents(boxes1)
    e2 = half_extents(boxes2)
    inter = None
    for axis in range(3):
        c1, h1 = boxes1[..., :, None, axis], e1[axis][..., :, None]
        c2, h2 = boxes2[..., None, :, axis], e2[axis][..., None, :]
        o = (torch.minimum(c1 + h1, c2 + h2) - torch.maximum(c1 - h1, c2 - h2)).clamp_min(0.0)
        inter = o if inter is None else inter * o
    v1 = (boxes1[..., 3] * boxes1[..., 4] * boxes1[..., 5])[..., :, None]
    v2 = (boxes2[..., 3] * boxes2[..., 4] * boxes2[..., 5])[..., None, :]
    inter = torch.minimum(inter, torch.minimum(v1, v2))
    return inter / (v1 + v2 - inter)
