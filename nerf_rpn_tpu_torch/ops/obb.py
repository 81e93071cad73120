"""Oriented (z-rotated) box conversions (port of ``nerf_rpn_tpu/ops/obb.py``).

2D OBBs are ``[x, y, w, h, theta]``; 3D OBBs are ``[x, y, z, w, l, h, theta]``
with theta the rotation about +z in radians.  Batched over leading dims,
with the JAX package's conventions and corner order.  Angles wrap with
``torch.remainder``, whose floor semantics are those of ``jnp``'s ``%``.
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def regular_theta(theta: torch.Tensor, mode: str = "180", start: float = -PI / 2) -> torch.Tensor:
    """Wrap angles into ``[start, start + cycle)`` (cycle = pi or 2*pi)."""
    assert mode in ("360", "180")
    cycle = 2 * PI if mode == "360" else PI
    return torch.remainder(theta - start, cycle) + start


def regular_obb(obb: torch.Tensor) -> torch.Tensor:
    """Canonicalise 2D OBBs so w >= h and theta in [-pi/2, pi/2)."""
    x, y, w, h, theta = obb.unbind(-1)
    swap = w > h
    w_r = torch.where(swap, w, h)
    h_r = torch.where(swap, h, w)
    t_r = regular_theta(torch.where(swap, theta, theta + PI / 2))
    return torch.stack([x, y, w_r, h_r, t_r], dim=-1)


def rectpoly2obb(polys: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rectangular 4-point polygon (..., 8) -> canonical 2D OBB (..., 5).

    theta is estimated from the first edge, the polygon is de-rotated, and
    the axis-aligned extent in the de-rotated frame gives (w, h).
    """
    theta = torch.atan2(-(polys[..., 3] - polys[..., 1]), polys[..., 2] - polys[..., 0] + eps)
    cos, sin = torch.cos(theta), torch.sin(theta)
    x = torch.mean(polys[..., 0::2], dim=-1)
    y = torch.mean(polys[..., 1::2], dim=-1)
    pts = polys.reshape(*polys.shape[:-1], 4, 2)
    centered = pts - torch.stack([x, y], dim=-1)[..., None, :]
    px = centered[..., 0] * cos[..., None] - centered[..., 1] * sin[..., None]
    py = centered[..., 0] * sin[..., None] + centered[..., 1] * cos[..., None]
    w = px.amax(dim=-1) - px.amin(dim=-1)
    h = py.amax(dim=-1) - py.amin(dim=-1)
    return regular_obb(torch.stack([x, y, w, h, theta], dim=-1))


def obb2poly(obb: torch.Tensor) -> torch.Tensor:
    """2D OBB (..., 5) -> 4-corner polygon (..., 8) = [x1,y1,...,x4,y4]."""
    ctr = obb[..., 0:2]
    w = obb[..., 2:3]
    h = obb[..., 3:4]
    theta = obb[..., 4:5]
    cos, sin = torch.cos(theta), torch.sin(theta)
    v1 = torch.cat([w / 2 * cos, -w / 2 * sin], dim=-1)
    v2 = torch.cat([-h / 2 * sin, -h / 2 * cos], dim=-1)
    p1 = ctr + v1 + v2
    p2 = ctr + v1 - v2
    p3 = ctr - v1 - v2
    p4 = ctr - v1 + v2
    return torch.cat([p1, p2, p3, p4], dim=-1)


def obb2poly_3d(obb: torch.Tensor) -> torch.Tensor:
    """3D OBB (..., 7) -> 8-corner 3D polygon (..., 24), lower 4 then upper 4."""
    obb2d = torch.cat([obb[..., 0:2], obb[..., 3:5], obb[..., 6:7]], dim=-1)
    pts = obb2poly(obb2d).reshape(*obb.shape[:-1], 4, 2)
    half_h = obb[..., 5:6] / 2
    z0 = (obb[..., 2:3] - half_h)[..., None, :].expand(*pts.shape[:-1], 1)
    z1 = (obb[..., 2:3] + half_h)[..., None, :].expand(*pts.shape[:-1], 1)
    lower = torch.cat([pts, z0], dim=-1)
    upper = torch.cat([pts, z1], dim=-1)
    return torch.cat([lower, upper], dim=-2).reshape(*obb.shape[:-1], 24)


def obb2hbb(obb: torch.Tensor) -> torch.Tensor:
    """2D OBB (..., 5) -> smallest enclosing AABB (..., 4) [x1,y1,x2,y2]."""
    ctr = obb[..., 0:2]
    w = obb[..., 2:3]
    h = obb[..., 3:4]
    theta = obb[..., 4:5]
    cos, sin = torch.cos(theta), torch.sin(theta)
    x_bias = torch.abs(w / 2 * cos) + torch.abs(h / 2 * sin)
    y_bias = torch.abs(w / 2 * sin) + torch.abs(h / 2 * cos)
    bias = torch.cat([x_bias, y_bias], dim=-1)
    return torch.cat([ctr - bias, ctr + bias], dim=-1)


def obb2hbb_3d(obb: torch.Tensor) -> torch.Tensor:
    """3D OBB (..., 7) -> smallest enclosing AABB (..., 6)."""
    ctr = obb[..., 0:2]
    z = obb[..., 2:3]
    w = obb[..., 3:4]
    l = obb[..., 4:5]
    h = obb[..., 5:6]
    theta = obb[..., 6:7]
    cos, sin = torch.cos(theta), torch.sin(theta)
    x_bias = torch.abs(w / 2 * cos) + torch.abs(l / 2 * sin)
    y_bias = torch.abs(w / 2 * sin) + torch.abs(l / 2 * cos)
    bias = torch.cat([x_bias, y_bias], dim=-1)
    z_bias = h / 2
    return torch.cat([ctr - bias, z - z_bias, ctr + bias, z + z_bias], dim=-1)


def obb2points_3d(obb: torch.Tensor) -> torch.Tensor:
    """3D OBB (..., 7) -> two diagonal endpoints (..., 2, 3), the summary of
    a box that the 2D projection loss projects."""
    ctr = obb[..., 0:3]
    w = obb[..., 3:4]
    l = obb[..., 4:5]
    h = obb[..., 5:6]
    theta = obb[..., 6:7]
    cos, sin = torch.cos(theta), torch.sin(theta)
    vec = torch.cat([w / 2 * cos - l / 2 * sin, w / 2 * sin + l / 2 * cos, h / 2], dim=-1)
    return torch.stack([ctr - vec, ctr + vec], dim=-2)
