"""Geometric augmentation of rgbsigma grids + boxes (host-side numpy).

Parity targets (reference ``datasets.py:109-163, 291-329``):
- 90-degree z-rotation: swap x/y axes then flip new x; AABB corners remapped,
  OBB (x, y) and (w, l) swapped with x mirrored.
- Per-axis flips (x, y for z-up): AABB corner mirror, OBB centre mirror +
  theta negation.
- Small rotation (+-10 deg) and scale (0.9-1.1) via an explicit rotated
  sampling grid (the reference deliberately avoids torch ``affine_grid``
  because it shears non-cubic volumes, ``datasets.py:300``) — here a direct
  trilinear resample with the align_corners=True coordinate convention.

Grids are channels-LAST (W, L, H, C) in this framework (TPU layout); the
augmentations operate on the spatial axes 0..2.

Copy of ``nerf_rpn_tpu/data/augment.py`` for the torch port.  The small
rotation + scale resamples in numpy only (the JAX package's native C++
resample is not carried over); it runs for OBB boxes only
(``run_rpn --rotated_bbox``).
"""

from __future__ import annotations

import numpy as np


def rotate90_z(rgbsigma: np.ndarray, boxes: np.ndarray | None):
    """90-degree rotation about +z (z-up)."""
    out = np.flip(np.swapaxes(rgbsigma, 0, 1), axis=0).copy()
    if boxes is not None:
        boxes = boxes.copy()
        new_w = out.shape[0]
        if boxes.shape[1] == 6:
            boxes[:, [0, 1, 3, 4]] = boxes[:, [1, 0, 4, 3]]
            boxes[:, [0, 3]] = new_w - boxes[:, [3, 0]]
        else:
            boxes[:, [0, 1, 3, 4]] = boxes[:, [1, 0, 4, 3]]
            boxes[:, 0] = new_w - boxes[:, 0]
    return out, boxes


def flip_axis(rgbsigma: np.ndarray, boxes: np.ndarray | None, axis: int):
    """Mirror along spatial ``axis`` (0 = x, 1 = y)."""
    out = np.flip(rgbsigma, axis=axis).copy()
    if boxes is not None:
        boxes = boxes.copy()
        extent = rgbsigma.shape[axis]
        if boxes.shape[1] == 6:
            boxes[:, [axis, axis + 3]] = extent - boxes[:, [axis + 3, axis]]
        else:
            boxes[:, axis] = extent - boxes[:, axis]
            boxes[:, -1] = -boxes[:, -1]
    return out, boxes


def _trilinear_sample(volume: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Sample (W, L, H, C) at float voxel coords (..., 3); zero padding
    outside (grid_sample zero-padding semantics)."""
    w, l, h, c = volume.shape
    shape = coords.shape[:-1]
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    z0 = np.floor(z).astype(np.int64)
    fx, fy, fz = x - x0, y - y0, z - z0

    out = np.zeros((*shape, c), volume.dtype)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                ok = (
                    (xi >= 0) & (xi < w) & (yi >= 0) & (yi < l)
                    & (zi >= 0) & (zi < h)
                )
                wgt = (
                    (fx if dx else 1 - fx)
                    * (fy if dy else 1 - fy)
                    * (fz if dz else 1 - fz)
                ) * ok
                vals = volume[
                    np.clip(xi, 0, w - 1),
                    np.clip(yi, 0, l - 1),
                    np.clip(zi, 0, h - 1),
                ]
                out += vals * wgt[..., None]
    return out


def rotate_and_scale(
    rgbsigma: np.ndarray, boxes: np.ndarray | None, angle: float, scale: float
):
    """Small z-rotation + isotropic scale, resampling the grid.

    OBB-only in the reference (``rotate_and_scale_scene``,
    ``datasets.py:291-329``): boxes get theta -= angle, sizes /= scale,
    centres rotated by R/scale about the grid centre.
    """
    res = rgbsigma.shape[:3]
    xform = np.array(
        [
            [np.cos(angle), -np.sin(angle), 0],
            [np.sin(angle), np.cos(angle), 0],
            [0, 0, 1],
        ],
        np.float32,
    ) * scale

    axes = [np.linspace(-1, 1, r, dtype=np.float32) * r / 2 for r in res]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    grid = grid @ xform.T
    # centred coords -> voxel coords (align_corners=True convention)
    src = np.empty_like(grid)
    for a in range(3):
        src[..., a] = (grid[..., a] / (res[a] / 2) + 1) / 2 * (res[a] - 1)
    out = _trilinear_sample(rgbsigma, src)

    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, 6] = boxes[:, 6] - angle
        boxes[:, 3:6] = boxes[:, 3:6] / scale
        center = np.asarray(res, np.float32) / 2
        offset = boxes[:, :3] - center
        boxes[:, :3] = offset @ (xform / (scale * scale)) + center
    return out, boxes


def augment_rpn_inputs(
    rgbsigma: np.ndarray,
    boxes: np.ndarray | None,
    rng: np.random.Generator,
    flip_prob: float = 0.0,
    rotate_prob: float = 0.0,
    rot_scale_prob: float = 0.0,
):
    """Random augmentation dispatch (reference ``augment_rpn_inputs``,
    z-up path)."""
    if rng.random() < rotate_prob:
        rgbsigma, boxes = rotate90_z(rgbsigma, boxes)
    for axis in (0, 1):
        if rng.random() < flip_prob:
            rgbsigma, boxes = flip_axis(rgbsigma, boxes, axis)
    if (
        boxes is not None
        and boxes.shape[1] == 7
        and rng.random() < rot_scale_prob
    ):
        angle = rng.uniform(-np.pi / 18, np.pi / 18)
        scale = rng.uniform(0.9, 1.1)
        rgbsigma, boxes = rotate_and_scale(rgbsigma, boxes, angle, scale)
    return rgbsigma, boxes
