"""Hypersim box preprocessing: transforms.json OBBs -> RPN .npy box files.

Parity target: reference ``data/hypersim/preprocess_boxes.py`` — the same
coordinate chain (nerf matrix -> ngp via y/z negate + xyz<-yzx cycle or
mitsuba flip, scale/offset; y-up -> z-up permutation for OBBs), the same
NYU40 exclusion list, manual CSV filters, degenerate/size filtering, and the
same two output formats: AABB ``[x1..z2]`` (rounded, clipped) or OBB
``[x, y, z, w, h, d, theta]`` (theta from the rotation matrix).

Copy of ``nerf_rpn_tpu/datatools/hypersim_boxes.py`` for the torch port, with the
same functions and CLI flags (``python -m
nerf_rpn_tpu_torch.datatools.hypersim_boxes --help``).
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

# problematic NYU40 labels (same exclusion list as the reference)
EXCLUDED_NYU40_LABELS = {1, 2, 8, 9, 11, 13, 16, 19, 20, 21, 22, 23, 25, 26,
                         27, 28, 30, 34}

_YUP_TO_ZUP = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float64)


def nerf_matrix_to_ngp(m: np.ndarray, scale: float, offset: np.ndarray,
                       from_mitsuba: bool) -> np.ndarray:
    out = m.copy()
    out[:, [1, 2]] *= -1
    out[:, 3] = out[:, 3] * scale + offset
    if from_mitsuba:
        out[:, [0, 2]] *= -1
    else:
        out = out[[1, 2, 0], :]  # cycle axes xyz <- yzx
    return out


def _obb_corners_ngp(xform: np.ndarray, extent: np.ndarray):
    signs = np.array(
        [[sx, sy, sz] for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)],
        np.float64,
    ).T  # (3, 8)
    corners = signs * extent[:, None] * 0.5
    corners = xform[:, :3] @ corners + xform[:, 3:4]
    return corners.min(axis=1), corners.max(axis=1)


def _iter_boxes(json_dict, filter_by_label):
    for obj in json_dict["bounding_boxes"]:
        if filter_by_label and (
            obj.get("label", -1) in EXCLUDED_NYU40_LABELS
            or obj.get("manually_filtered", False)
        ):
            continue
        yield (
            np.asarray(obj["extents"], np.float64),
            np.asarray(obj["orientation"], np.float64),
            np.asarray(obj["position"], np.float64),
        )


def process_aabbs(json_dict, scene_params, filter_by_label=False,
                  filter_by_size=False, min_size=2):
    """transforms.json boxes -> (N, 6) AABB grid-coordinate boxes."""
    res = np.asarray(scene_params["resolution"], np.float64)
    bb_min = np.asarray(scene_params["bbox_min"], np.float64)
    bb_max = np.asarray(scene_params["bbox_max"], np.float64)
    scale = float(scene_params["scale"])
    offset = np.asarray(scene_params["offset"], np.float64)
    mitsuba = bool(scene_params["from_mitsuba"])
    diag = bb_max - bb_min

    boxes = []
    for extent, orientation, position in _iter_boxes(json_dict, filter_by_label):
        xform = np.hstack([orientation, position[:, None]])
        xform = nerf_matrix_to_ngp(xform, scale, offset, mitsuba)
        lo, hi = _obb_corners_ngp(xform, extent * scale)
        lo = np.around((lo - bb_min) / diag * res).astype(int)
        hi = np.around((hi - bb_min) / diag * res).astype(int)
        boxes.append(np.concatenate([lo, hi]))
    if not boxes:
        return np.zeros((0, 6))
    boxes = np.asarray(boxes, np.float64)
    boxes[:, 0::3] = np.clip(boxes[:, 0::3], 0, res[0])
    boxes[:, 1::3] = np.clip(boxes[:, 1::3], 0, res[1])
    boxes[:, 2::3] = np.clip(boxes[:, 2::3], 0, res[2])
    keep = (boxes[:, 3:] > boxes[:, :3]).all(axis=1)
    boxes = boxes[keep]
    if filter_by_size:
        boxes = boxes[(boxes[:, 3:] - boxes[:, :3] >= min_size).all(axis=1)]
    return boxes


def process_obbs(json_dict, scene_params, filter_by_label=False,
                 filter_by_size=False, min_size=2):
    """transforms.json boxes -> (N, 7) OBB grid-coordinate boxes (z-up)."""
    res = _YUP_TO_ZUP @ np.asarray(scene_params["resolution"], np.float64)
    bb_min = _YUP_TO_ZUP @ np.asarray(scene_params["bbox_min"], np.float64)
    bb_max = _YUP_TO_ZUP @ np.asarray(scene_params["bbox_max"], np.float64)
    scale = float(scene_params["scale"])
    offset = np.asarray(scene_params["offset"], np.float64)
    mitsuba = bool(scene_params["from_mitsuba"])
    diag = bb_max - bb_min

    boxes = []
    for extent, orientation, position in _iter_boxes(json_dict, filter_by_label):
        xform = np.hstack([orientation, position[:, None]])
        xform = nerf_matrix_to_ngp(xform, scale, offset, mitsuba)
        xform = _YUP_TO_ZUP @ xform
        position = xform[:, 3]
        theta = (
            np.pi / 2 if xform[0, 0] == 0
            else np.arctan(xform[1, 0] / xform[0, 0])
        )
        if (position < bb_min).any() or (position > bb_max).any():
            continue
        position = (position - bb_min) / diag * res
        size = extent * scale / diag * res
        if filter_by_size and (size < min_size).any():
            continue
        boxes.append(np.concatenate([position, size, [theta]]))
    return np.asarray(boxes) if boxes else np.zeros((0, 7))


def apply_manual_filters(json_dict, csv_path):
    """Mark boxes from a manual-filter CSV (columns box_id,
    manually_filtered)."""
    for box in json_dict["bounding_boxes"]:
        box["manually_filtered"] = False
    if not os.path.exists(csv_path):
        print(f"No manual filter file found at {csv_path}")
        return json_dict
    count = 0
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            flt = int(row["manually_filtered"]) == 1
            json_dict["bounding_boxes"][int(row["box_id"])]["manually_filtered"] = flt
            count += flt
    print(f"{os.path.basename(csv_path)}: {count} boxes manually filtered")
    return json_dict


def load_and_add_labels(json_dict, mesh_path, sem_path):
    """Attach NYU40 labels from the Hypersim hdf5 metadata (gated on h5py)."""
    import h5py

    ext = h5py.File(os.path.join(
        mesh_path,
        "metadata_semantic_instance_bounding_box_object_aligned_2d_extents.hdf5",
    ), "r")["dataset"][:]
    ori = h5py.File(os.path.join(
        mesh_path,
        "metadata_semantic_instance_bounding_box_object_aligned_2d_orientations.hdf5",
    ), "r")["dataset"][:]
    si = h5py.File(os.path.join(sem_path, "mesh_objects_si.hdf5"), "r")[
        "dataset"][:].squeeze()
    sii = h5py.File(os.path.join(sem_path, "mesh_objects_sii.hdf5"), "r")[
        "dataset"][:].squeeze()

    boxes = json_dict["bounding_boxes"]
    hdf5_to_box, cur = {}, 0
    for i in range(len(ext)):
        if np.isinf(ext[i]).any() or np.isinf(ori[i]).any():
            hdf5_to_box[i] = -1
            continue
        hdf5_to_box[i] = cur
        cur += 1
    assert cur == len(boxes)
    for box in boxes:
        box["label"] = -1
    for i in range(len(si)):
        idx = sii[i] if sii[i] != -1 else 0
        box_idx = hdf5_to_box[idx]
        if box_idx != -1:
            boxes[box_idx]["label"] = int(si[i])


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert Hypersim transforms.json boxes to RPN .npy files.")
    p.add_argument("--format", choices=["aabb", "obb"], required=True)
    p.add_argument("--dataset_dir", default="")
    p.add_argument("--feature_dir", default="")
    p.add_argument("--output_dir", default="")
    p.add_argument("--manual_label_path", default="")
    p.add_argument("--filter_by_label", action="store_true")
    p.add_argument("--hypersim_path", default="")
    p.add_argument("--semantics", default="")
    p.add_argument("--filter_by_size", action="store_true")
    p.add_argument("--min_size", type=int, default=2)
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    scenes = [f[:-4] for f in os.listdir(args.feature_dir) if f.endswith(".npz")]
    for scene in scenes:
        scene_dir = os.path.join(args.dataset_dir, scene)
        if not os.path.isdir(scene_dir):
            continue
        with open(os.path.join(scene_dir, "train", "transforms.json")) as f:
            json_dict = json.load(f)
        scene_params = np.load(os.path.join(args.feature_dir, scene + ".npz"))
        if args.filter_by_label:
            load_and_add_labels(
                json_dict,
                os.path.join(args.hypersim_path, scene, "_detail", "mesh"),
                os.path.join(args.semantics, scene, "_detail", "mesh"))
        if args.manual_label_path:
            apply_manual_filters(
                json_dict, os.path.join(args.manual_label_path, scene + ".csv"))
        fn = process_aabbs if args.format == "aabb" else process_obbs
        boxes = fn(json_dict, scene_params, args.filter_by_label,
                   args.filter_by_size, args.min_size)
        np.save(os.path.join(args.output_dir, scene + ".npy"), boxes)
        print(f"{scene}: {len(boxes)} boxes")


if __name__ == "__main__":
    main()
