"""ScanNet instance boxes: min-area rotated rectangles + label/size filters.

Parity targets (reference ``data/scannet/``):
- ``minimum_bounding_rectangle`` <-> ``MinimumBoundingBox.py``: min-area
  rectangle of the xy-projection via rotating calipers over the convex hull
  (re-implemented from scratch: hull by monotone chain, rectangle per hull
  edge direction, argmin area).
- ``instance_obb`` <-> ``generate_bbox.find_minimum_bounding_box``: rectangle
  + z extent -> ``[cx, cy, cz, w, l, h, theta]``.
- ``generate_scene_boxes`` <-> ``generate_bbox.process_scene``: ScanNet
  aggregation/segment/ply instance extraction (ply parsing gated on a tiny
  built-in ASCII/binary-little-endian reader; no plyfile dependency).
- ``filter_boxes`` <-> ``filter_bbox.py``: same label exclusion list + grid
  coordinate conversion + min-size filter.

Copy of ``nerf_rpn_tpu/datatools/scannet_boxes.py`` for the torch port, with the
same functions and CLI flags (``python -m
nerf_rpn_tpu_torch.datatools.scannet_boxes --help``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

# same exclusion list as the reference filter (it is dataset config)
EXCLUDED_SCANNET_LABELS = {
    'shower curtain rod', 'paper towel', 'ledge', 'tape', 'paper towel roll',
    'light switch', 'rug', 'faucet', 'ceiling light', 'oven mitt', 'blinds',
    'clothing', 'structure', 'clothes hangers', 'clothes', 'vent', 'tray',
    'closet wall', 'handrail', 'bathroom stall', 'kitchen apron', 'thermostat',
    'swiffer', 'sign', 'hose', 'whiteboard eraser', 'closet rod',
    'toilet paper', 'loofa', 'windowsill', 'tube', 'shower door', 'broom',
    'hair dryer', 'tv stand', 'books', 'bath walls', 'rolled poster', 'floor',
    'clothes hanger', 'fire alarm', 'dustpan', 'stairs', 'bike lock',
    'lamp base', 'slippers', 'hanging', 'globe', 'doorframe', 'plunger',
    'window', 'book', 'sink', 'toilet paper dispenser', 'shower walls',
    'stair', 'shower floor', 'soap dispenser', 'toothbrush', 'banner', 'cup',
    'doors', 'power outlet', 'hand towel', 'curtains', 'clock', 'pipes',
    'wall hanging', 'mouse', 'alarm clock', 'bathroom stall door',
    'closet doors', 'towel', 'grab bar', 'closet door', 'shower wall',
    'blackboard', 'paper towel dispenser', 'food display', 'mug', 'mat',
    'toilet paper holder', 'ceiling', 'whiteboard', 'bulletin board',
    'tissue box', 'mail', 'scale', 'rope', 'music book', 'mirror',
    'decoration', 'painting', 'shower', 'staircase', 'poster', 'pantry walls',
    'curtain', 'shower head', 'light', 'smoke detector', 'pipe', 'paper bag',
    'laundry detergent', 'stair rail', 'projector screen', 'cutting board',
    'stapler', 'divider', 'mirror doors', 'paper', 'board', 'hair brush',
    'hand sanitzer dispenser', 'controller', 'plate', 'flip flops', 'shoe',
    'door', 'soap dish', 'toilet flush button', 'picture', 'power strip',
    'wall',
}


def convex_hull_2d(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain; points (N, 2) -> CCW hull vertices (H, 2)."""
    pts = np.unique(points, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(iterable):
        hull = []
        for p in iterable:
            while len(hull) >= 2:
                o, a = hull[-2], hull[-1]
                if (a[0] - o[0]) * (p[1] - o[1]) - (a[1] - o[1]) * (p[0] - o[0]) <= 0:
                    hull.pop()
                else:
                    break
            hull.append(p)
        return hull

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def minimum_bounding_rectangle(points: np.ndarray):
    """Min-area rectangle of 2D points.

    Returns (center (2,), length_parallel, length_orthogonal,
    unit_vector_angle) — the rectangle's long axis angle convention matches
    the reference's MinimumBoundingBox (angle of the edge direction giving
    minimal area).
    """
    hull = convex_hull_2d(points)
    if len(hull) == 1:
        return hull[0], 0.0, 0.0, 0.0
    if len(hull) == 2:
        d = hull[1] - hull[0]
        ang = float(np.arctan2(d[1], d[0]))
        return (hull[0] + hull[1]) / 2, float(np.hypot(*d)), 0.0, ang

    edges = np.roll(hull, -1, axis=0) - hull
    angles = np.arctan2(edges[:, 1], edges[:, 0])
    best = None
    for ang in angles:
        c, s = np.cos(-ang), np.sin(-ang)
        rot = points @ np.array([[c, -s], [s, c]]).T
        lo = rot.min(axis=0)
        hi = rot.max(axis=0)
        area = np.prod(hi - lo)
        if best is None or area < best[0]:
            ctr_rot = (lo + hi) / 2
            ctr = ctr_rot @ np.array([[np.cos(ang), -np.sin(ang)],
                                      [np.sin(ang), np.cos(ang)]]).T
            best = (area, ctr, float(hi[0] - lo[0]), float(hi[1] - lo[1]),
                    float(ang))
    _, ctr, lp, lo_, ang = best
    return ctr, lp, lo_, ang


def instance_obb(vertices: np.ndarray) -> np.ndarray:
    """(N, 3) instance vertices -> [cx, cy, cz, w, l, h, theta] (z-up)."""
    zmin, zmax = vertices[:, 2].min(), vertices[:, 2].max()
    ctr, lp, lo, ang = minimum_bounding_rectangle(vertices[:, :2])
    return np.array([ctr[0], ctr[1], (zmin + zmax) / 2, lp, lo, zmax - zmin, ang])


# ---------------------------------------------------------------------------
# ScanNet scene processing
# ---------------------------------------------------------------------------


def read_ply_vertices(path: str) -> np.ndarray:
    """Minimal PLY vertex reader (ascii or binary_little_endian x/y/z...)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n_verts = int(next(l.split()[2] for l in header
                           if l.startswith("element vertex")))
        props = []
        in_vertex = False
        for l in header:
            if l.startswith("element"):
                in_vertex = l.startswith("element vertex")
            elif l.startswith("property") and in_vertex:
                props.append(tuple(l.split()[1:3]))
        type_map = {"float": "f4", "float32": "f4", "double": "f8",
                    "uchar": "u1", "uint8": "u1", "int": "i4", "uint": "u4",
                    "short": "i2", "ushort": "u2", "char": "i1"}
        if fmt == "ascii":
            rows = [f.readline().split()[: len(props)] for _ in range(n_verts)]
            arr = np.asarray(rows, np.float64)
            idx = [i for i, (_, name) in enumerate(props) if name in "xyz"]
            return arr[:, idx].astype(np.float32)
        dtype = np.dtype([(name, "<" + type_map[t]) for t, name in props])
        data = np.frombuffer(f.read(n_verts * dtype.itemsize), dtype=dtype,
                             count=n_verts)
        return np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float32)


def generate_scene_boxes(scene_path: str, output_path: str):
    """ScanNet scene dir -> per-instance OBB json (reference
    ``generate_bbox.process_scene``)."""
    scene = os.path.basename(scene_path)
    with open(os.path.join(scene_path, f"{scene}_vh_clean.aggregation.json")) as f:
        aggregation = json.load(f)
    segments_file = aggregation["segmentsFile"].replace("scannet.", "")
    with open(os.path.join(scene_path, segments_file)) as f:
        seg_indices = np.asarray(json.load(f)["segIndices"])
    vertices = read_ply_vertices(
        os.path.join(scene_path, f"{scene}_vh_clean_2.ply"))

    instances = []
    for group in aggregation["segGroups"]:
        seg_set = set(group["segments"])
        mask = np.isin(seg_indices, list(seg_set))
        v = vertices[mask]
        if len(v) == 0:
            continue
        instances.append({
            "obj_id": group["objectId"],
            "label": group["label"],
            "min_pt": v.min(axis=0).tolist(),
            "max_pt": v.max(axis=0).tolist(),
            "obb": instance_obb(v).tolist(),
        })
    out = {"scene_name": scene, "instances": instances}
    with open(os.path.join(output_path, f"{scene}.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


def filter_boxes(feature_file: str, obj_json_file: str, npy_out: str,
                 json_out: str, min_size: float = 2.0):
    """Label + size filtering and grid-coordinate conversion (reference
    ``filter_bbox.filter_bbox``)."""
    data = np.load(feature_file)
    with open(obj_json_file) as f:
        json_dict = json.load(f)
    inst = json_dict["instances"]
    if not inst:
        np.save(npy_out, np.zeros((0, 7)))
        return
    obb = np.asarray([x["obb"] for x in inst], np.float64)
    min_pt = np.asarray([x["min_pt"] for x in inst]).min(axis=0)
    max_pt = np.asarray([x["max_pt"] for x in inst]).max(axis=0)
    res = np.asarray(data["resolution"], np.float64)
    diag = max_pt - min_pt
    obb[:, 3:6] = obb[:, 3:6] / diag * res
    obb[:, :3] = (obb[:, :3] - min_pt) / diag * res

    keep = np.array([
        x["label"] not in EXCLUDED_SCANNET_LABELS and obb[i, 3:6].min() >= min_size
        for i, x in enumerate(inst)
    ])
    np.save(npy_out, obb[keep])
    json_dict["instances"] = [x for i, x in enumerate(inst) if keep[i]]
    with open(json_out, "w") as f:
        json.dump(json_dict, f, indent=2)


def main(argv=None):
    p = argparse.ArgumentParser(description="ScanNet instance OBB extraction.")
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate")
    g.add_argument("--scene_path", required=True)
    g.add_argument("--output_path", required=True)
    f = sub.add_parser("filter")
    f.add_argument("--feature_path", required=True)
    f.add_argument("--json_path", required=True)
    f.add_argument("--output_path", required=True)
    f.add_argument("--min_size", type=float, default=2.0)
    args = p.parse_args(argv)

    if args.cmd == "generate":
        os.makedirs(args.output_path, exist_ok=True)
        for scene in sorted(os.listdir(args.scene_path)):
            sp = os.path.join(args.scene_path, scene)
            if os.path.isdir(sp):
                generate_scene_boxes(sp, args.output_path)
                print(scene)
    else:
        os.makedirs(args.output_path, exist_ok=True)
        for fjson in sorted(os.listdir(args.json_path)):
            if not fjson.endswith(".json"):
                continue
            scene = fjson[:-5]
            feature_file = os.path.join(args.feature_path, scene + ".npz")
            if not os.path.isfile(feature_file):
                continue
            filter_boxes(
                feature_file,
                os.path.join(args.json_path, fjson),
                os.path.join(args.output_path, scene + ".npy"),
                os.path.join(args.output_path, scene + ".json"),
                args.min_size)
            print(scene)


if __name__ == "__main__":
    main()
