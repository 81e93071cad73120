"""Project OBB/AABB instances into a scene's training frames as overlays
(port of ``nerf_rpn_tpu/tools/visualize_bbox.py``).

Parity target: reference ``data/scannet/visualize_bbox.py`` (223 LoC), which
projects each instance's oriented box into every ``transforms_train.json``
frame with cv2 and writes overlay images.  This version is headless and
dependency-light: the projection math matches the reference
(``visualize_bbox.py:64-98`` for the world→projection matrix,
``:101-126`` for OBB corners, ``:129-150`` for the 12 wireframe edges,
``:153-173`` for the label anchored at the topmost projected corner); line
rasterization is pure numpy and output is written with the same minimal PNG
writer as ``render_heatmap``.  PIL, when present, is used only to read the
source frames and draw label text; without it boxes are drawn on a black
canvas and labels are skipped.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from nerf_rpn_tpu_torch.tools.render_heatmap import save_png


def get_aabb_corners(min_pt, max_pt) -> np.ndarray:
    """8 corners of an axis-aligned box (reference order,
    ``visualize_bbox.py:34-51``)."""
    mx, mn = np.asarray(max_pt, np.float64), np.asarray(min_pt, np.float64)
    return np.array([
        mx,
        [mx[0], mx[1], mn[2]],
        [mx[0], mn[1], mn[2]],
        [mx[0], mn[1], mx[2]],
        [mn[0], mx[1], mx[2]],
        [mn[0], mx[1], mn[2]],
        mn,
        [mn[0], mn[1], mx[2]],
    ])


def get_obb_corners(obb) -> np.ndarray:
    """8 corners of ``[x, y, z, w, l, h, theta]`` (theta about +z, radians;
    reference ``visualize_bbox.py:101-126``)."""
    obb = np.asarray(obb, np.float64)
    corners = np.array([
        [-1, -1, -1], [-1, 1, -1], [1, 1, -1], [1, -1, -1],
        [-1, -1, 1], [-1, 1, 1], [1, 1, 1], [1, -1, 1],
    ], np.float64) * 0.5 * obb[3:6][None, :]
    c, s = np.cos(obb[6]), np.sin(obb[6])
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return (rot @ corners.T).T + obb[:3][None, :]


def get_world_to_proj_matrix(frame: dict, width: int, height: int):
    """NeRF-convention camera → screen-space projection (reference
    ``visualize_bbox.py:64-98``: flip y/z columns to OpenCV, then the
    fy-derived xyscale/zscale projection)."""
    cam2world = np.array(frame["transform_matrix"], np.float64)
    cam2world = cam2world.copy()
    cam2world[:, [1, 2]] *= -1
    focal = frame["fy"] / height
    zscale = 1.0 / focal
    xyscale = float(height)
    cam2proj = np.array([
        [xyscale, 0, width * 0.5 * zscale, 0],
        [0, xyscale, height * 0.5 * zscale, 0],
        [0, 0, 1, 0],
        [0, 0, zscale, 0],
    ])
    return cam2proj @ np.linalg.inv(cam2world)


def project_points(world2proj, pts) -> np.ndarray:
    """Homogeneous-project Nx3 world points; rows with w<=0 are dropped
    (reference ``get_projected_points``, ``visualize_bbox.py:54-61``)."""
    pts = np.asarray(pts, np.float64)
    h = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)
    proj = (world2proj @ h.T).T
    proj = proj[proj[:, 3] > 0]
    return (proj[:, :2] / proj[:, 3:4]).astype(np.int64)


def draw_line(img: np.ndarray, a, b, color) -> None:
    """Rasterize segment a→b (pixel coords) into (H, W, 3) uint8, clipped."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n = int(max(abs(b - a).max(), 1)) + 1
    xs = np.rint(np.linspace(a[0], b[0], n)).astype(np.int64)
    ys = np.rint(np.linspace(a[1], b[1], n)).astype(np.int64)
    keep = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[keep], xs[keep]] = color


def _edge(img, world2proj, a, b, color):
    ha = world2proj @ np.array([a[0], a[1], a[2], 1.0])
    hb = world2proj @ np.array([b[0], b[1], b[2], 1.0])
    if ha[3] <= 0 or hb[3] <= 0:
        return
    draw_line(img, ha[:2] / ha[3], hb[:2] / hb[3], color)


def render_bbox_overlay(img, world2proj, corners, color=(255, 0, 0)) -> None:
    """Draw the 12 box edges (reference edge pattern,
    ``visualize_bbox.py:145-150``: bottom ring, top ring, verticals)."""
    for i in range(4):
        _edge(img, world2proj, corners[i], corners[(i + 1) % 4], color)
        _edge(img, world2proj, corners[i + 4], corners[(i + 1) % 4 + 4], color)
        _edge(img, world2proj, corners[i], corners[i + 4], color)


def label_anchor(img_shape, world2proj, corners):
    """In-bounds projected corner with the smallest y (reference
    ``add_semantic_labels``, ``visualize_bbox.py:153-173``); None if the box
    is entirely off-screen."""
    projected = project_points(world2proj, corners)
    if projected.shape[0] < 2:
        return None
    keep = ((projected[:, 0] >= 0) & (projected[:, 0] < img_shape[1])
            & (projected[:, 1] >= 0) & (projected[:, 1] < img_shape[0]))
    projected = projected[keep]
    if projected.shape[0] == 0:
        return None
    return tuple(projected[np.argmin(projected[:, 1])])


def _draw_label(img, anchor, label, color):
    try:
        from PIL import Image, ImageDraw
    except Exception:
        return img
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    x, y = int(anchor[0]), int(anchor[1])
    draw.rectangle([x, max(y - 14, 0), x + 7 * len(label), y],
                   fill=tuple(int(c) for c in color))
    draw.text((x + 1, max(y - 13, 0)), label, fill=(255, 255, 255))
    return np.asarray(pil).copy()


def _load_image(path, default_hw=(480, 640)):
    try:
        from PIL import Image
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB")).copy()
    except Exception:
        return np.zeros((*default_hw, 3), np.uint8)


def process_scene(instances: dict, xform_dict: dict, scene_dir: str,
                  output_dir: str, box_key: str = "obb",
                  rng: np.random.Generator | None = None) -> list[str]:
    """Overlay every instance box on every frame (reference
    ``process_scene``, ``visualize_bbox.py:176-199``).  Returns the written
    paths.  ``box_key``: 'obb' uses ``instance['obb']``; 'aabb' uses
    min_pt/max_pt."""
    rng = rng or np.random.default_rng(0)
    written = []
    os.makedirs(output_dir, exist_ok=True)
    inst_list = instances["instances"]
    colors = rng.integers(0, 256, (len(inst_list), 3))
    for frame in xform_dict["frames"]:
        file_path = os.path.join(scene_dir, frame["file_path"])
        img = _load_image(file_path)
        h, w = img.shape[:2]
        world2proj = get_world_to_proj_matrix(frame, w, h)
        for inst, color in zip(inst_list, colors):
            if box_key == "aabb":
                corners = get_aabb_corners(inst["min_pt"], inst["max_pt"])
            else:
                corners = get_obb_corners(inst["obb"])
            render_bbox_overlay(img, world2proj, corners, color)
            anchor = label_anchor(img.shape, world2proj, corners)
            if anchor is not None and inst.get("label"):
                img = _draw_label(img, anchor, str(inst["label"]), color)
        name = os.path.splitext(os.path.basename(file_path))[0] + ".png"
        out_path = os.path.join(output_dir, name)
        save_png(out_path, np.ascontiguousarray(img))
        written.append(out_path)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Overlay instance boxes on scene training frames.")
    p.add_argument("--instance_path", required=True,
                   help="Directory of per-scene instance json files.")
    p.add_argument("--scene_dir", required=True,
                   help="Directory of per-scene NeRF dirs "
                        "(with transforms_train.json).")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--box_type", choices=("obb", "aabb"), default="obb")
    args = p.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    for scene in sorted(os.listdir(args.instance_path)):
        scene_name = scene.split(".")[0]
        with open(os.path.join(args.instance_path, f"{scene_name}.json")) as f:
            instances = json.load(f)
        with open(os.path.join(args.scene_dir, scene_name,
                               "transforms_train.json")) as f:
            xform_dict = json.load(f)
        process_scene(instances, xform_dict,
                      os.path.join(args.scene_dir, scene_name),
                      os.path.join(args.output_dir, scene_name),
                      box_key=args.box_type)
        print(scene_name)


if __name__ == "__main__":
    main()
