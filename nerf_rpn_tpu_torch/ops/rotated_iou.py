"""Differentiable rotated-box IoU and its losses (port of ``nerf_rpn_tpu/ops/rotated_iou.py``).

The chain the rotated IoU losses train on: two rotated rectangles are
intersected by convex-polygon clipping, and the 3D IoU multiplies the 2D
intersection by the z overlap.

1. ``box2corners``: (x, y, w, h, theta) -> 4 corners, counter-clockwise;
2. the 16 edge-pair intersections (masked; parallel edges never intersect)
   and the corners of each box inside the other (a projection test with
   relative tolerance ``_CONTAIN_TOL``): 24 candidate vertices and a mask;
3. the valid vertices centred on their masked mean and ordered by
   ``atan2`` (invalid slots keyed past ``_INVALID_KEY``, an index
   tie-break of ``i * 1e-6``), invalid slots filled with the first vertex,
   the shoelace area of the closed ring (0 with fewer than 3 vertices);
4. 3D IoU = (2D intersection x z overlap) / (v1 + v2 - intersection);
   GIoU and DIoU add an enclosing box (``aligned``, ``pca`` or
   ``smallest`` of the 24 candidate hull edges).

The math and its f32 order are the JAX module's.  Its 32-slot bitonic
network, a TPU workaround, is one stable ``torch.sort`` of the same keys
here: the valid keys are distinct, so both give the same order, and
autograd flows through the gathered vertex coordinates as it flows
through the network's selects.  Every gradient guard is kept: the angle
and the containment test see detached inputs, and a masked entry that
could reach a division takes the double-``where`` form, so a masked
value backprops zero, never NaN.

3D OBBs are ``[x, y, z, w, l, h, theta]``; the 2D sub-box is
``[x, y, w, l, theta]`` and the z extent is ``h``.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-8
_CONTAIN_TOL = 1e-5  # relative; the reference's 1e-6 drops corners of
# coincident boxes at typical scene coordinates
_INVALID_KEY = 100.0  # angles lie in (-pi, pi]; a key past ~99 is padding


def box2corners(box: torch.Tensor) -> torch.Tensor:
    """(..., 5) [x, y, w, h, theta] -> (..., 4, 2) corners, counter-clockwise
    from (+w/2, +h/2) at theta = 0."""
    x, y, w, h, theta = box.unbind(-1)
    xs = torch.stack([w / 2, -w / 2, -w / 2, w / 2], dim=-1)
    ys = torch.stack([h / 2, h / 2, -h / 2, -h / 2], dim=-1)
    cos = torch.cos(theta)[..., None]
    sin = torch.sin(theta)[..., None]
    rx = xs * cos - ys * sin
    ry = xs * sin + ys * cos
    return torch.stack([rx + x[..., None], ry + y[..., None]], dim=-1)


def _segment_intersections(corners1: torch.Tensor, corners2: torch.Tensor):
    """All 4x4 edge-pair intersections: ``(inter (..., 4, 4, 2), mask (...,
    4, 4))``, the points zero in value and gradient where masked."""
    p1, q1 = corners1, corners1.roll(-1, dims=-2)
    p2, q2 = corners2, corners2.roll(-1, dims=-2)
    x1, y1 = p1[..., :, None, 0], p1[..., :, None, 1]
    x2, y2 = q1[..., :, None, 0], q1[..., :, None, 1]
    x3, y3 = p2[..., None, :, 0], p2[..., None, :, 1]
    x4, y4 = q2[..., None, :, 0], q2[..., None, :, 1]

    num = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    den_t = (x1 - x3) * (y3 - y4) - (y1 - y3) * (x3 - x4)
    den_u = (x1 - x2) * (y1 - y3) - (y1 - y2) * (x1 - x3)
    parallel = num == 0.0
    safe_num = torch.where(parallel, 1.0, num)
    t_exact = torch.where(parallel, -1.0, den_t / safe_num)
    u_exact = torch.where(parallel, -1.0, -den_u / safe_num)
    mask = (t_exact > 0.0) & (t_exact < 1.0) & (u_exact > 0.0) & (u_exact < 1.0)
    # the stabilised t of the coordinates (den / (num + EPS)), zeroed where
    # masked before it forms them: near-parallel pairs make it huge, and
    # the divisor of a masked pair is replaced so its zero cotangent cannot
    # become 0/0 in the backward
    safe_den = torch.where(mask, num + EPS, 1.0)
    t = torch.where(mask, den_t / safe_den, 0.0)
    ix = x1 + t * (x2 - x1)
    iy = y1 + t * (y2 - y1)
    inter = torch.stack([ix, iy], dim=-1) * mask[..., None]
    return inter, mask


def _corners_in_box(corners: torch.Tensor, box_corners: torch.Tensor) -> torch.Tensor:
    """True where each of ``corners`` (..., 4, 2) lies inside the rectangle
    with corners ``box_corners`` (..., 4, 2).  A boolean decision: its
    inputs are detached, so a zero-area box's 0/0 cannot reach the
    backward."""
    corners = corners.detach()
    box_corners = box_corners.detach()
    a = box_corners[..., 0:1, :]
    ab = box_corners[..., 1:2, :] - a
    ad = box_corners[..., 3:4, :] - a
    am = corners - a
    r_ab = torch.sum(ab * am, dim=-1) / torch.sum(ab * ab, dim=-1)
    r_ad = torch.sum(ad * am, dim=-1) / torch.sum(ad * ad, dim=-1)
    return ((r_ab > -_CONTAIN_TOL) & (r_ab < 1.0 + _CONTAIN_TOL)
            & (r_ad > -_CONTAIN_TOL) & (r_ad < 1.0 + _CONTAIN_TOL))


def _masked_polygon_area(vertices: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Area of the convex polygon of the valid ``vertices`` (..., K, 2)
    under ``mask`` (..., K); 0 with fewer than 3 valid vertices."""
    maskf = mask.to(vertices.dtype)
    num_valid = mask.sum(dim=-1)
    denom = num_valid.clamp_min(1).to(vertices.dtype)
    mean = torch.sum(vertices * maskf[..., None], dim=-2) / denom[..., None]
    centered = vertices - mean[..., None, :]
    # the angle is only a sort key: detached, so atan2's undefined gradient
    # at (0, 0) (every zeroed invalid vertex of an empty polygon) stays out
    ang = torch.atan2(centered[..., 1].detach(), centered[..., 0].detach())
    tie = torch.arange(ang.shape[-1], dtype=vertices.dtype, device=vertices.device) * 1e-6
    key = torch.where(mask, ang, _INVALID_KEY) + tie
    key, order = torch.sort(key, dim=-1, stable=True)
    sx = torch.gather(centered[..., 0], -1, order)
    sy = torch.gather(centered[..., 1], -1, order)
    filled = key < _INVALID_KEY / 2
    rx = torch.where(filled, sx, sx[..., 0:1])
    ry = torch.where(filled, sy, sy[..., 0:1])
    nx, ny = rx.roll(-1, dims=-1), ry.roll(-1, dims=-1)
    area = torch.abs(torch.sum(rx * ny - ry * nx, dim=-1)) / 2
    return torch.where(num_valid >= 3, area, 0.0)


def oriented_box_intersection_area(corners1: torch.Tensor,
                                   corners2: torch.Tensor) -> torch.Tensor:
    """Intersection area of two rotated rectangles from their corners (..., 4, 2)."""
    inter, mask_inter = _segment_intersections(corners1, corners2)
    batch = corners1.shape[:-2]
    vertices = torch.cat([corners1, corners2, inter.reshape(*batch, 16, 2)], dim=-2)
    mask = torch.cat([_corners_in_box(corners1, corners2), _corners_in_box(corners2, corners1),
                      mask_inter.reshape(*batch, 16)], dim=-1)
    return _masked_polygon_area(vertices, mask)


def iou_rotated_2d(box1: torch.Tensor, box2: torch.Tensor):
    """Elementwise rotated 2D IoU of (..., 5) boxes: ``(iou, corners1,
    corners2, union_area)``."""
    corners1 = box2corners(box1)
    corners2 = box2corners(box2)
    inter = oriented_box_intersection_area(corners1, corners2)
    union = box1[..., 2] * box1[..., 3] + box2[..., 2] * box2[..., 3] - inter
    return inter / union, corners1, corners2, union


def _split_3d(box3d: torch.Tensor):
    """(..., 7) -> the 2D sub-box (..., 5), zmin and zmax."""
    box2d = torch.cat([box3d[..., 0:2], box3d[..., 3:5], box3d[..., 6:7]], dim=-1)
    half = box3d[..., 5] * 0.5
    return box2d, box3d[..., 2] - half, box3d[..., 2] + half


def iou_rotated_3d(box3d1: torch.Tensor, box3d2: torch.Tensor, verbose: bool = False):
    """Elementwise rotated 3D IoU of (..., 7) boxes.  With ``verbose``:
    ``(iou3d, corners1, corners2, z_range, union3d)``, ``z_range`` the z
    extent of the pair's enclosing box."""
    box1, zmin1, zmax1 = _split_3d(box3d1)
    box2, zmin2, zmax2 = _split_3d(box3d2)
    z_overlap = (torch.minimum(zmax1, zmax2) - torch.maximum(zmin1, zmin2)).clamp_min(0.0)
    iou_2d, corners1, corners2, u = iou_rotated_2d(box1, box2)
    inter_3d = iou_2d * u * z_overlap
    v1 = torch.prod(box3d1[..., 3:6], dim=-1)
    v2 = torch.prod(box3d2[..., 3:6], dim=-1)
    u3d = v1 + v2 - inter_3d
    iou3d = inter_3d / u3d
    if verbose:
        z_range = (torch.maximum(zmax1, zmax2) - torch.minimum(zmin1, zmin2)).clamp_min(0.0)
        return iou3d, corners1, corners2, z_range, u3d
    return iou3d


# ---------------------------------------------------------------------------
# Enclosing boxes (GIoU / DIoU)
# ---------------------------------------------------------------------------


def _enclosing_aligned(corners1: torch.Tensor, corners2: torch.Tensor):
    c = torch.cat([corners1, corners2], dim=-2)
    w = c[..., 0].amax(dim=-1) - c[..., 0].amin(dim=-1)
    h = c[..., 1].amax(dim=-1) - c[..., 1].amin(dim=-1)
    return w, h


def _enclosing_pca(corners1: torch.Tensor, corners2: torch.Tensor):
    """The enclosing box along the principal axes of the 8 corners, from the
    closed-form eigenvectors of their 2x2 covariance.  In f32: the JAX
    module casts to float64, which JAX without x64 keeps at float32."""
    c = torch.cat([corners1, corners2], dim=-2)  # (..., 8, 2)
    c = c - c.mean(dim=-2, keepdim=True)
    cov = torch.einsum("...ki,...kj->...ij", c, c)
    a, cc, b = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]
    # (a - b)^2 + 4 cc^2 >= 0; the 1e-30 keeps sqrt's gradient finite at
    # the isotropic point
    delta = torch.sqrt(a * a + 4 * cc * cc - 2 * a * b + b * b + 1e-30)
    safe_c = torch.where(cc == 0, EPS, cc)
    one = torch.ones_like(a)
    v1 = torch.stack([(a - b - delta) / (2 * safe_c), one], dim=-1)
    v2 = torch.stack([(a - b + delta) / (2 * safe_c), one], dim=-1)
    v1 = v1 / torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
    v2 = v2 / torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
    p1 = torch.sum(c * v1[..., None, :], dim=-1)
    p2 = torch.sum(c * v2[..., None, :], dim=-1)
    return p1.amax(-1) - p1.amin(-1), p2.amax(-1) - p2.amin(-1)


def _build_hull_tables():
    """The 24 candidate hull edges over the 8 corners (the 4 rectangle
    diagonals skipped) and, per edge, the other 6 corner indices."""
    skip = {(0, 2), (1, 3), (5, 7), (4, 6)}
    lines, points = [], []
    for i in range(8):
        for j in range(i + 1, 8):
            if (i, j) in skip:
                continue
            lines.append((i, j))
            points.append([k for k in range(8) if k not in (i, j)])
    return np.array(lines, np.int64), np.array(points, np.int64)


_HULL_LINES, _HULL_POINTS = _build_hull_tables()


def _enclosing_smallest(corners1: torch.Tensor, corners2: torch.Tensor):
    """The smallest enclosing rectangle of the 8 corners, over the 24
    candidate hull edges: for each, the extent across the edge (distances
    of the other 6 corners) times the extent along it (projections of all
    8); the first edge of least area wins, as ``argmin`` picks."""
    c = torch.cat([corners1, corners2], dim=-2)  # (..., 8, 2)
    lines = c[..., torch.from_numpy(_HULL_LINES).to(c.device), :]    # (..., 24, 2, 2)
    others = c[..., torch.from_numpy(_HULL_POINTS).to(c.device), :]  # (..., 24, 6, 2)
    p1 = lines[..., 0, :]
    d = lines[..., 1, :] - p1
    norm = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-14)
    rel = others - p1[..., None, :]
    perp = (d[..., None, 0] * rel[..., 1] - d[..., None, 1] * rel[..., 0]) / norm[..., None]
    dist = torch.maximum(perp.amax(-1) - perp.amin(-1), perp.abs().amax(-1))
    rel8 = c[..., None, :, :] - p1[..., None, :]
    proj = torch.sum(rel8 * (d / norm[..., None])[..., None, :], dim=-1)
    proj_span = proj.amax(-1) - proj.amin(-1)
    area = proj_span * dist
    # coincident endpoints give zero area: never the answer
    area = torch.where(area == 0.0, 1e8, area)
    idx = torch.argmin(area, dim=-1, keepdim=True)
    return (torch.gather(proj_span, -1, idx)[..., 0], torch.gather(dist, -1, idx)[..., 0])


def enclosing_box(corners1: torch.Tensor, corners2: torch.Tensor,
                  enclosing_type: str = "smallest"):
    """``(w, h)`` of the pair's enclosing box by strategy."""
    if enclosing_type == "aligned":
        return _enclosing_aligned(corners1, corners2)
    if enclosing_type == "pca":
        return _enclosing_pca(corners1, corners2)
    if enclosing_type == "smallest":
        return _enclosing_smallest(corners1, corners2)
    raise ValueError(f"Unknown enclosing type: {enclosing_type}")


def giou_rotated_3d(box3d1: torch.Tensor, box3d2: torch.Tensor,
                    enclosing_type: str = "smallest"):
    """3D rotated GIoU loss: ``(giou_loss, giou, iou3d)``."""
    iou3d, corners1, corners2, z_range, u3d = iou_rotated_3d(box3d1, box3d2, verbose=True)
    w, h = enclosing_box(corners1, corners2, enclosing_type)
    v_c = z_range * w * h
    giou_loss = 1.0 - iou3d + (v_c - u3d) / v_c
    return giou_loss, 1.0 - giou_loss, iou3d


def diou_rotated_3d(box3d1: torch.Tensor, box3d2: torch.Tensor,
                    enclosing_type: str = "smallest"):
    """3D rotated DIoU loss: ``(diou_loss, iou3d)``."""
    iou3d, corners1, corners2, z_range, _ = iou_rotated_3d(box3d1, box3d2, verbose=True)
    w, h = enclosing_box(corners1, corners2, enclosing_type)
    offset = box3d1[..., 0:3] - box3d2[..., 0:3]
    d2 = torch.sum(offset * offset, dim=-1)
    c2 = w * w + h * h + z_range * z_range
    return 1.0 - iou3d + d2 / c2, iou3d
