"""Camera rig of the 2D projection loss (port of ``nerf_rpn_tpu/utils/projection.py``).

Four cameras at ``centroid + (+-res, +-res, +res)`` look at the grid
centroid with up = (0, 0, 1); intrinsics 640x480, f = 600.  The rig is
numpy, built once per resolution; ``project_points`` is torch.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

IMG_W, IMG_H, FOCAL = 640, 480, 600.0


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / (n if n != 0 else 1.0)


def _look_at_w2c(cam_pos: np.ndarray, at: np.ndarray, up=(0, 0, 1)) -> np.ndarray:
    z_axis = _normalize(cam_pos - at)
    x_axis = _normalize(np.cross(np.asarray(up, np.float64), z_axis))
    y_axis = _normalize(np.cross(z_axis, x_axis))
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x_axis, y_axis, z_axis, cam_pos
    return np.linalg.inv(c2w)


@lru_cache(maxsize=None)
def camera_rig(res: int = 160) -> tuple[np.ndarray, np.ndarray]:
    """(K (3, 3), w2cs (4, 4, 4)) f32 of the 4-camera rig at ``res``."""
    k = np.array([[FOCAL, 0, IMG_W / 2], [0, FOCAL, IMG_H / 2], [0, 0, 1]], np.float32)
    centroid = np.full(3, res / 2.0)
    offsets = np.array(
        [[res, res, res], [res, -res, res], [-res, res, res], [-res, -res, res]],
        np.float64)
    w2cs = np.stack([_look_at_w2c(centroid + off, centroid) for off in offsets])
    return k, w2cs.astype(np.float32)


def project_points(points: torch.Tensor, res: int) -> torch.Tensor:
    """(..., 3) points -> (..., 4, 2) pixel coordinates, one per camera (the
    rig's f32 constants, widened for f64 points)."""
    dtype = torch.promote_types(points.dtype, torch.float32)
    k, w2cs = (torch.from_numpy(a).to(points.device, dtype) for a in camera_rig(res))
    homo = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    cam = torch.einsum("cij,...j->...ci", w2cs, homo)
    pic = torch.einsum("ij,...cj->...ci", k, cam[..., :3])
    return pic[..., :2] / pic[..., 2:3]
