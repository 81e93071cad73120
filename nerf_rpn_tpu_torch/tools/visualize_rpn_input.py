"""PLY point/box dumps of rgbsigma grids, gt boxes, and voxel scores (port
of ``nerf_rpn_tpu/tools/visualize_rpn_input.py``; OBB corners through this
package's ``ops/obb.obb2poly_3d`` on the CPU).

Parity target: reference ``nerf_rpn/scripts/visualize_rpn_input.py`` — dumps
(a) the alpha-thresholded occupancy point cloud (optionally RGB- or
colormap-coloured), (b) AABB/OBB wireframes, (c) multi-level objectness
heatmaps upsampled to the grid — all as ASCII PLY viewable in MeshLab.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from nerf_rpn_tpu_torch.data.datasets import density_to_alpha_ngp, density_to_alpha_relu
from nerf_rpn_tpu_torch.ops.obb import obb2poly_3d


_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def _turbo_colormap(x: np.ndarray) -> np.ndarray:
    """Cheap 3-stop blue->green->red colormap, x in [0, 1] -> uint8 RGB."""
    x = np.clip(x, 0, 1)
    r = np.clip(2 * x - 0.5, 0, 1)
    g = 1 - np.abs(2 * x - 1)
    b = np.clip(1 - 2 * x, 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def aabb_corners(box: np.ndarray) -> np.ndarray:
    x1, y1, z1, x2, y2, z2 = box[:6]
    return np.array([
        [x1, y1, z1], [x2, y1, z1], [x2, y2, z1], [x1, y2, z1],
        [x1, y1, z2], [x2, y1, z2], [x2, y2, z2], [x1, y2, z2],
    ])


def obb_corners(box: np.ndarray) -> np.ndarray:
    """The 8 corners of ``[x, y, z, w, l, h, theta]``, lower 4 then upper 4
    (in f32, as the JAX tool computes them)."""
    obb = torch.as_tensor(np.asarray(box)[None], dtype=torch.float32)
    return obb2poly_3d(obb).numpy().reshape(8, 3)


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None,
              boxes: list[np.ndarray] | None = None):
    """ASCII PLY with optional per-point colours and box wireframe edges."""
    boxes = boxes or []
    n_box_verts = 8 * len(boxes)
    n_edges = len(_EDGES) * len(boxes)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points) + n_box_verts}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        has_color = colors is not None
        if has_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element edge {n_edges}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for i, pt in enumerate(points):
            line = f"{pt[0]:.3f} {pt[1]:.3f} {pt[2]:.3f}"
            if has_color:
                c = colors[i]
                line += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(line + "\n")
        for corners in boxes:
            for c in corners:
                line = f"{c[0]:.3f} {c[1]:.3f} {c[2]:.3f}"
                if has_color:
                    line += " 255 0 0"
                f.write(line + "\n")
        for b, _ in enumerate(boxes):
            base = len(points) + 8 * b
            for e0, e1 in _EDGES:
                f.write(f"{base + e0} {base + e1}\n")


def visualize_scene(
    scene: str,
    output_dir: str,
    feature_dir: str,
    box_dir: str | None = None,
    box_format: str = "obb",
    objectness_dir: str | None = None,
    alpha_threshold: float = 0.01,
    transpose_yz: bool = False,
    density_type: str = "ngp",
):
    with np.load(os.path.join(feature_dir, scene + ".npz")) as feats:
        rgbsigma = feats["rgbsigma"].astype(np.float32)
    if rgbsigma.max() > 1.5:  # uint8-scaled
        rgbsigma = rgbsigma / 255.0
    alpha_fn = density_to_alpha_ngp if density_type == "ngp" else density_to_alpha_relu
    alpha = alpha_fn(rgbsigma[..., -1])
    if transpose_yz:
        alpha = np.transpose(alpha, (0, 2, 1))
        rgbsigma = np.transpose(rgbsigma, (0, 2, 1, 3))

    idx = np.argwhere(alpha > alpha_threshold)
    rgb = (rgbsigma[..., :3][tuple(idx.T)] * 255).astype(np.uint8)

    boxes = []
    if box_dir is not None:
        raw = np.load(os.path.join(box_dir, scene + ".npy"))
        for b in raw:
            boxes.append(
                obb_corners(b) if box_format == "obb" and b.shape[-1] == 7
                else aabb_corners(b)
            )

    os.makedirs(output_dir, exist_ok=True)
    write_ply(os.path.join(output_dir, f"{scene}.ply"),
              idx.astype(np.float32), rgb, boxes)

    if objectness_dir is not None:
        with np.load(os.path.join(objectness_dir, scene + ".npz")) as scores:
            for level in scores.files:
                s = scores[level]
                # upsample score grid to voxel coords by repetition
                stride = int(round(alpha.shape[0] / s.shape[0]))
                pts = np.argwhere(np.ones_like(s, bool)) * stride + stride // 2
                vals = s.reshape(-1)
                vals = (vals - vals.min()) / max(vals.max() - vals.min(), 1e-6)
                write_ply(
                    os.path.join(output_dir, f"{scene}_objectness_{level}.ply"),
                    pts.astype(np.float32), _turbo_colormap(vals))


def main(argv=None):
    p = argparse.ArgumentParser(description="Dump rgbsigma grids / boxes to PLY.")
    p.add_argument("--feature_dir", required=True)
    p.add_argument("--box_dir", default=None)
    p.add_argument("--box_format", choices=["aabb", "obb"], default="obb")
    p.add_argument("--objectness_dir", default=None)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--alpha_threshold", type=float, default=0.01)
    p.add_argument("--transpose_yz", action="store_true")
    p.add_argument("--density_type", choices=["ngp", "relu"], default="ngp")
    args = p.parse_args(argv)

    scenes = [f[:-4] for f in os.listdir(args.feature_dir) if f.endswith(".npz")]
    for scene in scenes:
        visualize_scene(
            scene, args.output_dir, args.feature_dir, args.box_dir,
            args.box_format, args.objectness_dir, args.alpha_threshold,
            args.transpose_yz, args.density_type)
        print(scene)


if __name__ == "__main__":
    main()
