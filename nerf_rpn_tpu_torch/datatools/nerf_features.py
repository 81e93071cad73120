"""NeRF -> rgbsigma voxel-grid feature extraction.

Parity target: the reference's patched dense-depth-priors ``run_nerf.py``
``extract`` task (``data/scannet/run_nerf.py:1144-1210``): build a grid of
``max_res`` samples inside the scene bbox, query the NeRF at every grid
point (mean RGB over training poses via sigmoid, raw sigma), and save an
``rgbsigma`` npz in the RPN input layout ``(W, L, H, C)``.

The torch port of ``nerf_rpn_tpu/datatools/nerf_features.py``, with the same
functions, keys, layouts and npz contract.  The NeRF is a torch callable:
``extract_rgbsigma`` moves each chunk of grid points to its ``device`` (the
GPU unless the caller asks for the CPU), calls the network there and brings
the results back to the host grid; ``mean_rgb_over_poses`` runs on the
device of the points it is given.  Both run without autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_rpn_tpu_torch.device import resolve_device


def build_sample_grid(bbox_min, bbox_max, max_res: int, centers: bool = True):
    """Sample points over the scene bbox.

    Returns (points (W*L*H, 3) float32, resolution (3,) int) where the
    longest bbox side gets ``max_res`` samples and the others scale
    proportionally (reference resolution rule, ``run_nerf.py:1160-1162``).
    ``centers=True`` samples voxel centres; ``centers=False`` reproduces the
    reference's endpoint-inclusive ``linspace(min, max, res)`` positions
    (``run_nerf.py:1167-1169``).
    """
    bbox_min = np.asarray(bbox_min, np.float64)
    bbox_max = np.asarray(bbox_max, np.float64)
    diag = bbox_max - bbox_min
    res = np.round(diag / diag.max() * max_res).astype(int)
    res = np.maximum(res, 1)
    if centers:
        axes = [
            bbox_min[i] + (np.arange(res[i]) + 0.5) / res[i] * diag[i]
            for i in range(3)
        ]
    else:
        axes = [np.linspace(bbox_min[i], bbox_max[i], res[i])
                for i in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.float32), res


def grid_to_ddp_flat(rgbsigma: np.ndarray) -> np.ndarray:
    """(W, L, H, C) grid -> the reference extractor's flat (W*L*H, C) layout.

    The reference flattens ``meshgrid(z, y, x)`` row-major
    (``run_nerf.py:1171-1172``), so the flat index is
    ``(iz * L + iy) * W + ix`` — x fastest.
    """
    return np.ascontiguousarray(rgbsigma.transpose(2, 1, 0, 3)).reshape(
        -1, rgbsigma.shape[-1])


def ddp_flat_to_grid(flat: np.ndarray, resolution) -> np.ndarray:
    """Inverse of :func:`grid_to_ddp_flat`: a reference-produced flat
    ``rgbsigma`` + its ``resolution=(W, L, H)`` -> our (W, L, H, C) grid."""
    w, l, h = (int(r) for r in resolution)
    return np.ascontiguousarray(
        flat.reshape(h, l, w, flat.shape[-1]).transpose(2, 1, 0, 3))


@torch.no_grad()
def mean_rgb_over_poses(query_fn, poses, points, chunk: int = 65536):
    """The reference extract task's exact RGB/sigma semantics
    (``run_nerf.py:1183-1193``): for each training pose, the view direction
    is the camera's -z axis in world space (``R @ [0, 0, -1]``); RGB is
    ``sigmoid(raw_rgb)`` averaged over poses (summed in float64); sigma is
    the RAW (unactivated) density from the final pose query
    (view-independent in the DDP NeRF, so "last pose" == "any pose").

    ``query_fn(points (N, 3), viewdir (3,)) -> raw (N, 4)``, torch tensors on
    the points' device: raw network outputs (pre-sigmoid rgb,
    pre-activation sigma).  ``poses``: (P, 3, 4) or (P, 4, 4)
    camera-to-world matrices.  ``points``: (N, 3), a tensor (on any device)
    or an array (on the CPU).  Returns float32 ``(rgb_mean (N, 3), sigma
    (N,))`` on the points' device.
    """
    poses = np.asarray(poses, np.float32)
    points = torch.as_tensor(points, dtype=torch.float32)
    n = points.shape[0]
    rgb_sum = torch.zeros((n, 3), dtype=torch.float64, device=points.device)
    sigma = torch.zeros((n,), dtype=torch.float32, device=points.device)
    for pose in poses:
        viewdir = torch.from_numpy(
            pose[:3, :3] @ np.asarray([0.0, 0.0, -1.0], np.float32)).to(points.device)
        for start in range(0, n, chunk):
            raw = query_fn(points[start:start + chunk], viewdir)
            rgb_sum[start:start + chunk] += torch.sigmoid(raw[:, :3])
            sigma[start:start + chunk] = raw[:, 3]
    return (rgb_sum / len(poses)).float(), sigma


@torch.no_grad()
def extract_rgbsigma(
    nerf_fn,
    bbox_min,
    bbox_max,
    max_res: int = 160,
    chunk: int = 65536,
    output_file: str | None = None,
    extra_arrays: dict | None = None,
    centers: bool = True,
    ddp_layout: bool = False,
    scale: float = 1.0,
    offset=(0.0, 0.0, 0.0),
    from_mitsuba: bool = False,
    device: str | torch.device = "cuda",
):
    """Query ``nerf_fn`` over the grid and assemble (W, L, H, 4) rgbsigma.

    ``nerf_fn(points (N, 3) float32 on device) -> (rgb (N, 3) in [0, 1],
    sigma (N,) raw)`` tensors (wrap a raw per-pose network with
    :func:`mean_rgb_over_poses` for the reference's exact mean-sigmoid-RGB
    semantics).  ``device`` is where each chunk of points goes; it
    defaults to the GPU and raises without one.  When ``output_file`` is
    given, writes the npz every downstream consumer reads — ``load_scene``
    (the datasets), ``proposals2ngp`` and the visualizers all take
    rgbsigma/resolution/bbox_min/bbox_max/scale/offset/from_mitsuba:
    the reference extract emits the same keys (``run_nerf.py:1151-1154``)
    but with a scalar ``offset`` its own ``proposals2ngp`` cannot consume
    (``perm @ offset`` needs a 3-vector) — ours stores the 3-vector.

    ``ddp_layout=True`` reproduces the reference dense-depth-priors file
    contract instead (``run_nerf.py:1144-1155``): FLAT (W*L*H, 4) rgbsigma
    with x-fastest ordering and the scalar offset, plus ``from_ddp_nerf``;
    use :func:`ddp_flat_to_grid` to ingest such files.
    """
    dev = resolve_device(device)
    points, res = build_sample_grid(bbox_min, bbox_max, max_res,
                                    centers=centers)
    n = points.shape[0]
    out = np.zeros((n, 4), np.float32)
    for start in range(0, n, chunk):
        pts = torch.from_numpy(points[start : start + chunk]).to(dev)
        rgb, sigma = nerf_fn(pts)
        out[start : start + chunk, :3] = rgb.to("cpu", torch.float32).numpy()
        out[start : start + chunk, 3] = sigma.to("cpu", torch.float32).numpy().reshape(-1)
    rgbsigma = out.reshape(*res, 4)
    if output_file is not None:
        payload = {
            "rgbsigma": grid_to_ddp_flat(rgbsigma) if ddp_layout else rgbsigma,
            "resolution": np.asarray(res),
            "bbox_min": np.asarray(bbox_min, np.float32),
            "bbox_max": np.asarray(bbox_max, np.float32),
            "scale": float(scale),
            "from_mitsuba": bool(from_mitsuba),
        }
        if ddp_layout:
            payload.update(offset=0.0, from_ddp_nerf=True)
        else:
            payload.update(offset=np.asarray(offset, np.float32))
        payload.update(extra_arrays or {})
        np.savez_compressed(output_file, **payload)
    return rgbsigma, res
