"""Box coders (port of ``nerf_rpn_tpu/ops/coders.py``).

- AABB: the Faster-RCNN 6-delta parameterisation (centre offsets over size,
  log size ratios) with the exp clamped at log(2000).
- Midpoint offset: an OBB against an AABB anchor as 8 deltas -- the AABB
  deltas of the OBB's enclosing box, plus the offsets of the corners on its
  bottom and right edges from the centre, over the enclosing box's size.
- Rotated (the RCNN second stage): an OBB against an OBB RoI as 7 deltas
  -- the centre offset turned into the RoI's frame over its size, log size
  ratios and the angle difference over 2 pi; the decode wraps the angle to
  (-pi/2, pi/2] with a floor-mod (``torch.remainder``, JAX's ``%``).
"""

from __future__ import annotations

import math

import torch

from nerf_rpn_tpu_torch.ops.obb import PI, obb2hbb, obb2poly, rectpoly2obb

BBOX_XFORM_CLIP = math.log(2000.0)


def _aabb_ctr_size(boxes: torch.Tensor):
    size = boxes[..., 3:6] - boxes[..., 0:3]
    ctr = boxes[..., 0:3] + 0.5 * size
    return ctr, size


def encode_aabb(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """(..., 6) gt AABBs vs (..., 6) anchor AABBs -> (..., 6) deltas."""
    a_ctr, a_size = _aabb_ctr_size(anchors)
    g_ctr, g_size = _aabb_ctr_size(gt)
    d_ctr = (g_ctr - a_ctr) / a_size
    d_size = torch.log(g_size / a_size)
    return torch.cat([d_ctr, d_size], dim=-1)


def decode_aabb(deltas: torch.Tensor, anchors: torch.Tensor,
                xform_clip: float = BBOX_XFORM_CLIP) -> torch.Tensor:
    """(..., 6) deltas + (..., 6) anchors -> (..., 6) AABBs.

    As in JAX, the clamp and exp run in the deltas' dtype and the products
    with the (f32) anchors promote to f32.
    """
    a_ctr, a_size = _aabb_ctr_size(anchors)
    ctr = deltas[..., 0:3] * a_size + a_ctr
    size = torch.exp(deltas[..., 3:6].clamp(max=xform_clip)) * a_size
    return torch.cat([ctr - 0.5 * size, ctr + 0.5 * size], dim=-1)


_MID_TOL = 0.1  # corner-on-edge tolerance, the reference's


def _gt_midpoint_params(gt: torch.Tensor):
    """gt OBB (..., 7) -> (gx, gy, gw, gh, ga, gb): the enclosing AABB's
    centre and size, then the x of the corner(s) on the bottom edge and the
    y of the corner(s) on the right edge."""
    gt2d = torch.cat([gt[..., 0:2], gt[..., 3:5], gt[..., 6:7]], dim=-1)
    hbb = obb2hbb(gt2d)                      # (..., 4)
    poly = obb2poly(gt2d)                    # (..., 8)
    gx = (hbb[..., 0] + hbb[..., 2]) * 0.5
    gy = (hbb[..., 1] + hbb[..., 3]) * 0.5
    gw = hbb[..., 2] - hbb[..., 0]
    gh = hbb[..., 3] - hbb[..., 1]
    xc = poly[..., 0::2]
    yc = poly[..., 1::2]
    y_min = yc.amin(dim=-1, keepdim=True)
    x_max = xc.amax(dim=-1, keepdim=True)
    ga = torch.where(torch.abs(yc - y_min) > _MID_TOL, -1000.0, xc).amax(dim=-1)
    gb = torch.where(torch.abs(xc - x_max) > _MID_TOL, -1000.0, yc).amax(dim=-1)
    return gx, gy, gw, gh, ga, gb


def encode_midpoint_offset(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """gt OBB (..., 7) vs anchor AABB (..., 6) -> 8 deltas (..., 8)."""
    a_ctr, a_size = _aabb_ctr_size(anchors)
    px, py, pz = a_ctr.unbind(-1)
    pw, ph, pd = a_size.unbind(-1)
    gx, gy, gw, gh, ga, gb = _gt_midpoint_params(gt)
    gz = gt[..., 2]
    gd = gt[..., 5]
    return torch.stack([
        (gx - px) / pw,
        (gy - py) / ph,
        (gz - pz) / pd,
        torch.log(gw / pw),
        torch.log(gh / ph),
        torch.log(gd / pd),
        (ga - gx) / gw,
        (gb - gy) / gh,
    ], dim=-1)


def decode_midpoint_offset(deltas: torch.Tensor, anchors: torch.Tensor,
                           wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
    """8 deltas (..., 8) + anchor AABB (..., 6) -> OBB (..., 7)."""
    a_ctr, a_size = _aabb_ctr_size(anchors)
    max_ratio = abs(math.log(wh_ratio_clip))
    dx, dy, dz = deltas[..., 0], deltas[..., 1], deltas[..., 2]
    dw = deltas[..., 3].clamp(-max_ratio, max_ratio)
    dh = deltas[..., 4].clamp(-max_ratio, max_ratio)
    dd = deltas[..., 5].clamp(-max_ratio, max_ratio)
    da = deltas[..., 6].clamp(-0.5, 0.5)
    db = deltas[..., 7].clamp(-0.5, 0.5)

    gx = a_ctr[..., 0] + a_size[..., 0] * dx
    gy = a_ctr[..., 1] + a_size[..., 1] * dy
    gz = a_ctr[..., 2] + a_size[..., 2] * dz
    gw = a_size[..., 0] * torch.exp(dw)
    gh = a_size[..., 1] * torch.exp(dh)
    gd = a_size[..., 2] * torch.exp(dd)

    x1, y1 = gx - gw * 0.5, gy - gh * 0.5
    x2, y2 = gx + gw * 0.5, gy + gh * 0.5
    ga = gx + da * gw
    ga_ = gx - da * gw
    gb = gy + db * gh
    gb_ = gy - db * gh
    # the quad through the four edge points, stretched to a rectangle: each
    # corner pushed out along its diagonal to the longest one
    polys = torch.stack([ga, y1, x2, gb, ga_, y2, x1, gb_], dim=-1)
    ctr = torch.stack([gx, gy] * 4, dim=-1)
    centered = polys - ctr
    diag = torch.sqrt(centered[..., 0::2] ** 2 + centered[..., 1::2] ** 2)
    scale = diag.amax(dim=-1, keepdim=True) / diag
    centered = centered * torch.repeat_interleave(scale, 2, dim=-1)
    obb2d = rectpoly2obb(centered + ctr)  # (..., 5)
    return torch.cat([obb2d[..., 0:2], gz[..., None], obb2d[..., 2:4], gd[..., None],
                      obb2d[..., 4:5]], dim=-1)


def encode_rotated(gt: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
    """gt OBB (..., 7) vs RoI OBB (..., 7) -> 7 deltas (..., 7)."""
    cos = torch.cos(rois[..., 6])
    sin = torch.sin(rois[..., 6])
    off = gt[..., 0:3] - rois[..., 0:3]
    dx = (cos * off[..., 0] + sin * off[..., 1]) / rois[..., 3]
    dy = (-sin * off[..., 0] + cos * off[..., 1]) / rois[..., 4]
    dz = off[..., 2] / rois[..., 5]
    dsize = torch.log(gt[..., 3:6] / rois[..., 3:6])
    dangle = (gt[..., 6] - rois[..., 6]) / (2 * PI)
    return torch.cat([torch.stack([dx, dy, dz], dim=-1), dsize, dangle[..., None]], dim=-1)


def decode_rotated(deltas: torch.Tensor, rois: torch.Tensor,
                   xform_clip: float = BBOX_XFORM_CLIP) -> torch.Tensor:
    """7 deltas (..., 7) + RoI OBB (..., 7) -> OBB (..., 7).

    The deltas keep their dtype until they meet the (f32) RoIs, as in JAX:
    the clamp and exp of the sizes run in it, and 2 pi is rounded to it
    before the angle's product (JAX's weakly typed constant).
    """
    cos = torch.cos(rois[..., 6])
    sin = torch.sin(rois[..., 6])
    dx, dy, dz = deltas[..., 0], deltas[..., 1], deltas[..., 2]
    dsize = deltas[..., 3:6].clamp(max=xform_clip)
    dangle = deltas[..., 6]
    x = dx * rois[..., 3] * cos - dy * rois[..., 4] * sin + rois[..., 0]
    y = dx * rois[..., 3] * sin + dy * rois[..., 4] * cos + rois[..., 1]
    z = dz * rois[..., 5] + rois[..., 2]
    size = torch.exp(dsize) * rois[..., 3:6]
    two_pi = torch.full((), 2 * PI, dtype=dangle.dtype, device=dangle.device)
    angle = torch.remainder(two_pi * dangle + rois[..., 6], PI)
    angle = torch.where(angle > PI / 2, angle - PI, angle)
    return torch.cat([torch.stack([x, y, z], dim=-1), size, angle[..., None]], dim=-1)
