"""Volume-render voxel-score heatmaps from the ``voxel_scores`` dumps (port
of ``nerf_rpn_tpu/tools/render_heatmap.py``; the drivers'
``--output_voxel_scores`` files).

Parity target: reference ``nerf_rpn/scripts/render_heatmap.py``, which
volume-renders the per-level objectness scores with pyvista/plotly (neither
is in this image).  This version renders with pure numpy: the multi-level
scores are max-combined onto the full grid, gaussian-smoothed, and
alpha-composited along a chosen axis into a PNG (plus an optional PLY export
via ``visualize_rpn_input.write_ply`` for 3D viewers).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from nerf_rpn_tpu_torch.tools.visualize_rpn_input import _turbo_colormap, write_ply


def gaussian_kernel_1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_filter_3d(vol: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return vol
    radius = max(1, int(3 * sigma))
    k = gaussian_kernel_1d(sigma, radius)
    out = vol
    for axis in range(3):
        out = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), axis, out)
    return out


def combine_levels(scores_npz, grid_shape) -> np.ndarray:
    """Max-combine per-level score grids upsampled to the full grid."""
    combined = np.zeros(grid_shape, np.float32)
    for level in scores_npz.files:
        s = np.asarray(scores_npz[level], np.float32)
        reps = [int(np.ceil(g / d)) for g, d in zip(grid_shape, s.shape)]
        up = np.repeat(np.repeat(np.repeat(s, reps[0], 0), reps[1], 1), reps[2], 2)
        up = up[: grid_shape[0], : grid_shape[1], : grid_shape[2]]
        combined = np.maximum(combined, up)
    return combined


def composite_heatmap(vol: np.ndarray, axis: int = 2, absorption: float = 4.0):
    """Front-to-back alpha compositing of a scalar volume -> (H, W, 3) u8."""
    v = np.moveaxis(vol, axis, 0)
    v = (v - v.min()) / max(v.max() - v.min(), 1e-6)
    rgb = _turbo_colormap(v).astype(np.float32) / 255.0  # (D, H, W, 3)
    alpha = 1.0 - np.exp(-absorption * v / v.shape[0])
    out = np.zeros(v.shape[1:] + (3,), np.float32)
    trans = np.ones(v.shape[1:], np.float32)
    for d in range(v.shape[0]):
        a = alpha[d]
        out += (trans * a)[..., None] * rgb[d]
        trans *= 1.0 - a
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def save_png(path: str, img: np.ndarray):
    """Minimal PNG writer (no external imaging deps)."""
    import struct
    import zlib

    h, w = img.shape[:2]
    raw = b"".join(
        b"\x00" + img[row].tobytes() for row in range(h)
    )

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def render_scene(scene, scores_dir, output_dir, grid_shape=None, sigma=1.0,
                 axis=2, export_ply=False, threshold=0.3):
    with np.load(os.path.join(scores_dir, scene + ".npz")) as scores:
        if grid_shape is None:
            top = np.asarray(scores[scores.files[0]])
            stride = 2 ** (int(scores.files[0]) + 2)
            grid_shape = tuple(int(d * stride) for d in top.shape)
        combined = combine_levels(scores, grid_shape)
    combined = gaussian_filter_3d(combined, sigma)
    img = composite_heatmap(combined, axis=axis)
    os.makedirs(output_dir, exist_ok=True)
    save_png(os.path.join(output_dir, f"{scene}_heatmap.png"), img)
    if export_ply:
        norm = (combined - combined.min()) / max(np.ptp(combined), 1e-6)
        idx = np.argwhere(norm > threshold)
        write_ply(os.path.join(output_dir, f"{scene}_heatmap.ply"),
                  idx.astype(np.float32),
                  _turbo_colormap(norm[tuple(idx.T)]))


def main(argv=None):
    p = argparse.ArgumentParser(description="Render voxel-score heatmaps.")
    p.add_argument("--scores_dir", required=True,
                   help="Directory of voxel_scores npz dumps.")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--axis", type=int, default=2, help="Composite axis.")
    p.add_argument("--export_ply", action="store_true")
    args = p.parse_args(argv)
    scenes = [f[:-4] for f in os.listdir(args.scores_dir) if f.endswith(".npz")]
    for scene in scenes:
        render_scene(scene, args.scores_dir, args.output_dir,
                     sigma=args.sigma, axis=args.axis,
                     export_ply=args.export_ply)
        print(scene)


if __name__ == "__main__":
    main()
