"""Rotated 3D RoI align / pool as a differentiable gather (port of
``nerf_rpn_tpu/ops/roi_align.py``).

For each output bin a fixed grid of ``sampling_ratio``^3 points is laid in
the RoI's local frame, turned about z by theta, sampled trilinearly from
the feature volume and reduced (mean for align, max for the pooling mode).
The rules are the JAX package's:

- theta is in radians (the reference CUDA kernel took degrees);
- ``sampling_ratio`` is a fixed sample count per bin axis;
- a sample counts only where all three of its coordinates lie in ``[0,
  s - 1]``; otherwise the whole sample is zero.  Its corners are clamped
  into the grid, not zero-padded one by one, so neither ``F.grid_sample``
  nor torchvision's ``roi_align`` computes it;
- the multi-level form turns an AABB RoI into ``(centre, size, theta =
  0)``, scales its sizes by ``1 + enlarge_scale`` and pools a RoI whose
  level is out of range, or which is invalid, to zeros.

Weights are f32, so a bf16 feature times its weight is f32, as in JAX.  The
8 corners are gathered and accumulated one at a time: a full-size eval
(2 x 1024 RoIs, 3^3 bins, 2^3 samples, 256 channels) never holds all of
them at once.  The gather is advanced indexing, whose backward is
``index_put_(accumulate=True)`` (deterministic under
``torch.use_deterministic_algorithms(True)``).

The multi-level form gathers from one flat row buffer of all levels, each
RoI at its own level through a per-RoI base row and strides, so the
level of a RoI selects rows without a host sync.  The JAX package lays
that buffer out level-major to keep XLA's layouts; only the row offsets
depend on it here.  A RoI-align kernel is not written yet (plain torch on
every device).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _in_bounds(x, y, z, sx, sy, sz):
    return (x >= 0) & (x <= sx - 1) & (y >= 0) & (y <= sy - 1) & (z >= 0) & (z <= sz - 1)


def _clip(v: torch.Tensor, hi) -> torch.Tensor:
    """``clip(v, 0, hi)`` for a scalar or tensor ``hi``."""
    v = v.clamp(min=0)
    return torch.minimum(v, hi) if torch.is_tensor(hi) else v.clamp(max=hi)


def _corners(pts: torch.Tensor, sx, sy, sz):
    """Yield ``(xi, yi, zi, w)`` of the 8 trilinear corners of ``pts`` (...,
    3) in the order of the JAX loops (dx, dy, dz), clamped into
    ``[0, s - 1]``, with their f32 weights."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0, y - y0, z - z0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                xi = _clip(x0 + dx, sx - 1).long()
                yi = _clip(y0 + dy, sy - 1).long()
                zi = _clip(z0 + dz, sz - 1).long()
                w = (fx if dx else 1 - fx) * (fy if dy else 1 - fy) * (fz if dz else 1 - fz)
                yield xi, yi, zi, w


def trilinear_gather(volume: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Sample (X, Y, Z, C) at float coordinates ``pts`` (..., 3); a sample
    with any coordinate outside ``[0, s - 1]`` is zero."""
    sx, sy, sz, _ = volume.shape
    out = 0.0
    for xi, yi, zi, w in _corners(pts, sx, sy, sz):
        out = out + volume[xi, yi, zi] * w[..., None]
    inside = _in_bounds(pts[..., 0], pts[..., 1], pts[..., 2], sx, sy, sz)
    return out * inside[..., None]


def _axis_offsets(n_bins: int, s: int, device) -> torch.Tensor:
    """Bin centres subdivided s times: ``(b + (k + 0.5) / s) / n_bins - 0.5``."""
    b = torch.arange(n_bins, dtype=torch.float32, device=device)
    k = (torch.arange(s, dtype=torch.float32, device=device) + 0.5) / s
    return (b[:, None] + k[None, :]) / n_bins - 0.5  # (n_bins, s)


def roi_sample_points(rois: torch.Tensor, output_size: Sequence[int],
                      sampling_ratio: int) -> torch.Tensor:
    """Sample coordinates of each RoI: rois (R, 7) ``[cx, cy, cz, w, l, h,
    theta]`` in feature-grid units -> (R, ox, oy, oz, S^3, 3)."""
    ox, oy, oz = output_size
    s = sampling_ratio
    dev = rois.device
    fx = _axis_offsets(ox, s, dev)
    fy = _axis_offsets(oy, s, dev)
    fz = _axis_offsets(oz, s, dev)
    lx = fx[:, None, None, :, None, None]
    ly = fy[None, :, None, None, :, None]
    lz = fz[None, None, :, None, None, :]
    lx, ly, lz = torch.broadcast_tensors(lx, ly, lz)
    local = torch.stack([lx, ly, lz], dim=-1).reshape(ox, oy, oz, s ** 3, 3)
    scaled = local[None] * rois[:, None, None, None, None, 3:6]
    cos = torch.cos(rois[:, 6])[:, None, None, None, None]
    sin = torch.sin(rois[:, 6])[:, None, None, None, None]
    rx = scaled[..., 0] * cos - scaled[..., 1] * sin
    ry = scaled[..., 0] * sin + scaled[..., 1] * cos
    pts = torch.stack([rx, ry, scaled[..., 2]], dim=-1)
    return pts + rois[:, None, None, None, None, 0:3]


def _reduce(vals: torch.Tensor, mode: str) -> torch.Tensor:
    """Mean or max over the samples axis (-2)."""
    if mode == "avg":
        return vals.mean(dim=-2)
    if mode == "max":
        return vals.amax(dim=-2)
    raise ValueError(mode)


def roi_align_rotated_3d(features: torch.Tensor, rois: torch.Tensor,
                         spatial_scale: float = 1.0, output_size: Sequence[int] = (4, 4, 4),
                         sampling_ratio: int = 2, mode: str = "avg") -> torch.Tensor:
    """(X, Y, Z, C) features + (R, 7) OBB RoIs in mesh coordinates -> (R,
    ox, oy, oz, C); ``spatial_scale`` divides the RoIs' coordinates into
    feature-grid units.  ``mode``: ``avg`` (align) or ``max`` (pooling)."""
    r = torch.cat([rois[:, 0:6] * (1.0 / spatial_scale), rois[:, 6:]], dim=-1)
    pts = roi_sample_points(r, tuple(output_size), sampling_ratio)
    return _reduce(trilinear_gather(features, pts), mode)


def _as_obb(rois: torch.Tensor, rotated: bool, enlarge_scale: float) -> torch.Tensor:
    """(R, 6|7) RoIs -> (R, 7) OBBs with sizes scaled by ``1 +
    enlarge_scale``; an AABB becomes (centre, size, 0)."""
    if rotated:
        obb = rois
    else:
        ctr = (rois[:, 0:3] + rois[:, 3:6]) / 2
        size = rois[:, 3:6] - rois[:, 0:3]
        obb = torch.cat([ctr, size, rois.new_zeros((rois.shape[0], 1))], dim=-1)
    return torch.cat([obb[:, 0:3], obb[:, 3:6] * (1.0 + enlarge_scale), obb[:, 6:]], dim=-1)


def multilevel_roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
                         levels: torch.Tensor, valid: torch.Tensor,
                         spatial_scales: Sequence[float], output_size: Sequence[int] = (4, 4, 4),
                         sampling_ratio: int = 2, mode: str = "avg", rotated: bool = True,
                         enlarge_scale: float = 0.2) -> torch.Tensor:
    """RoI features of one scene from an FPN pyramid: per-level (X_l, Y_l,
    Z_l, C) features, (R, 6|7) RoIs in mesh coordinates, (R,) levels and
    valid -> (R, ox, oy, oz, C)."""
    pooled = multilevel_roi_align_batched(
        [f[None] for f in features], rois[None], levels[None], valid[None], spatial_scales,
        output_size, sampling_ratio, mode, rotated, enlarge_scale)
    return pooled[0]


def multilevel_roi_align_batched(features: Sequence[torch.Tensor], rois: torch.Tensor,
                                 levels: torch.Tensor, valid: torch.Tensor,
                                 spatial_scales: Sequence[float],
                                 output_size: Sequence[int] = (4, 4, 4),
                                 sampling_ratio: int = 2, mode: str = "avg",
                                 rotated: bool = True,
                                 enlarge_scale: float = 0.2) -> torch.Tensor:
    """Batched :func:`multilevel_roi_align`: features (B, X_l, Y_l, Z_l, C)
    per level, rois (B, R, 6|7), levels and valid (B, R) -> (B, R, ox, oy,
    oz, C), f32 (or the features' dtype where it is wider)."""
    b, r = rois.shape[:2]
    c = features[0].shape[-1]
    dev = rois.device
    n_levels = len(features)
    dims_np = np.asarray([f.shape[1:4] for f in features], np.int64)      # (L, 3)
    sizes = dims_np.prod(axis=1)
    # level-major rows: level l's block holds its B scenes back to back
    offsets_np = np.concatenate([[0], np.cumsum(sizes * b)[:-1]]).astype(np.int64)
    flat = torch.cat([f.reshape(-1, c) for f in features], dim=0)

    rois = rois.reshape(b * r, rois.shape[-1])
    levels = levels.reshape(b * r)
    valid = valid.reshape(b * r)
    scene = torch.arange(b, device=dev).repeat_interleave(r)
    obb = _as_obb(rois, rotated, enlarge_scale)

    lvl = levels.clamp(0, n_levels - 1).long()
    in_range = (levels >= 0) & (levels < n_levels)
    scale = torch.tensor(np.asarray(spatial_scales, np.float32), device=dev)[lvl]
    dims = torch.from_numpy(dims_np).to(dev)[lvl]                          # (R, 3)
    base = (torch.from_numpy(offsets_np).to(dev)[lvl]
            + scene * torch.from_numpy(sizes).to(dev)[lvl])

    obb = torch.cat([obb[:, 0:6] * (1.0 / scale)[:, None], obb[:, 6:]], dim=-1)
    pts = roi_sample_points(obb, tuple(output_size), sampling_ratio)
    bshape = (-1,) + (1,) * (pts.dim() - 2)
    sx, sy, sz = (dims[:, i].reshape(bshape) for i in range(3))
    fsx, fsy, fsz = (d.to(pts.dtype) for d in (sx, sy, sz))
    base = base.reshape(bshape)
    out = 0.0
    for xi, yi, zi, w in _corners(pts, fsx, fsy, fsz):
        idx = base + (xi * sy + yi) * sz + zi
        out = out + flat[idx] * w[..., None]
    inside = _in_bounds(pts[..., 0], pts[..., 1], pts[..., 2], fsx, fsy, fsz)
    pooled = _reduce(out * inside[..., None], mode)
    sel = (in_range & valid).to(pooled.dtype)
    pooled = pooled * sel[:, None, None, None, None]
    return pooled.reshape(b, r, *pooled.shape[1:])


def map_rois_to_levels(boxes: torch.Tensor, k_min: int, k_max: int,
                       canonical_scale: int = 160, canonical_level: int = 4,
                       eps: float = 1e-6) -> torch.Tensor:
    """FPN eqn-1 level of each box from its cube-root volume (reference
    ``LevelMapper``): boxes (..., 6|7) -> level indices relative to
    ``k_min``."""
    if boxes.shape[-1] == 7:
        dims = boxes[..., 3:6]
    else:
        dims = boxes[..., 3:6] - boxes[..., 0:3]
    vol = dims[..., 0] * dims[..., 1] * dims[..., 2]
    s = torch.pow(vol, 1.0 / 3.0)
    lvl = torch.floor(canonical_level + torch.log2(s / canonical_scale) + eps)
    return (lvl.clamp(k_min, k_max) - k_min).to(torch.int32)


def map_rois_to_levels_np(boxes, k_min: int, k_max: int, canonical_scale: int = 160,
                          canonical_level: int = 4, eps: float = 1e-6) -> np.ndarray:
    """The numpy level mapper that the stage-2 collate runs on the host
    (``--remap``), in the JAX package's float32 arithmetic."""
    boxes = np.asarray(boxes, np.float32)
    if boxes.shape[-1] == 7:
        vol = np.prod(boxes[..., 3:6], axis=-1)
    else:
        vol = np.prod(boxes[..., 3:6] - boxes[..., 0:3], axis=-1)
    s = np.cbrt(vol)
    with np.errstate(divide="ignore", invalid="ignore"):
        lvl = np.floor(np.float32(canonical_level) + np.log2(s / np.float32(canonical_scale))
                       + np.float32(eps))
    lvl = np.clip(np.nan_to_num(lvl, nan=k_min, neginf=k_min, posinf=k_max), k_min, k_max)
    return (lvl - k_min).astype(np.int32)
