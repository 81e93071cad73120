"""Export RPN proposals into instant-ngp ``transforms.json`` bounding boxes
(port of ``nerf_rpn_tpu/tools/proposals2ngp.py``; the drivers'
``--output_proposals`` files).

Parity target: reference ``nerf_rpn/scripts/proposals2ngp.py`` — same CLI
(--bbox_format aabb|obb, --dataset, --threshold, --top_k) and the same
coordinate chain: grid coords -> scene bbox -> z-up -> y-up axis permutation
-> ngp -> nerf matrix convention (cycle xyz->yzx or mitsuba flip, negate
y/z columns, unscale translation).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

_ZUP_TO_YUP = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float64)


def ngp_matrix_to_nerf(m: np.ndarray, scale: float, offset: np.ndarray,
                       from_mitsuba: bool) -> np.ndarray:
    out = m.copy()
    if from_mitsuba:
        out[:, [0, 2]] *= -1
    else:
        out = out[[2, 0, 1], :]  # cycle axes xyz -> yzx
    out[:, [1, 2]] *= -1
    out[:, 3] = (out[:, 3] - offset) / scale
    return out


def _scene_params(features_dict):
    # offset may be a scalar (the ScanNet extract writes 0.0,
    # run_nerf.py:1151-1154 — the reference's own proposals2ngp crashes on
    # it at `perm @ offset`); broadcast to the 3-vector the math needs
    offset = np.asarray(features_dict["offset"], np.float64)
    return (
        np.asarray(features_dict["resolution"], np.float64),
        np.asarray(features_dict["bbox_min"], np.float64),
        np.asarray(features_dict["bbox_max"], np.float64),
        float(features_dict["scale"]),
        offset * np.ones(3) if offset.ndim == 0 else offset,
        bool(features_dict["from_mitsuba"]),
    )


def aabb_proposals_to_ngp(proposals: np.ndarray, features_dict) -> list[dict]:
    res, bb_min, bb_max, scale, offset, mitsuba = _scene_params(features_dict)
    diag = bb_max - bb_min
    lo = proposals[:, :3] / res * diag + bb_min
    hi = proposals[:, 3:6] / res * diag + bb_min
    offset_yup = _ZUP_TO_YUP @ offset
    boxes = []
    for a, b in zip(lo, hi):
        xform = np.concatenate(
            [np.eye(3), ((a + b) / 2)[:, None]], axis=1)
        xform = _ZUP_TO_YUP @ xform
        xform = ngp_matrix_to_nerf(xform, scale, offset_yup, mitsuba)
        boxes.append({
            "orientation": xform[:3, :3].tolist(),
            "position": xform[:3, 3].tolist(),
            "extents": ((b - a) / scale).tolist(),
        })
    return boxes


def obb_proposals_to_ngp(proposals: np.ndarray, features_dict) -> list[dict]:
    res, bb_min, bb_max, scale, offset, mitsuba = _scene_params(features_dict)
    diag = bb_max - bb_min
    pos = proposals[:, :3] / res * diag + bb_min
    ext = proposals[:, 3:6] / res * diag / scale
    theta = proposals[:, 6]
    offset_yup = _ZUP_TO_YUP @ offset
    boxes = []
    for p, e, t in zip(pos, ext, theta):
        rot = np.array([
            [np.cos(t), -np.sin(t), 0],
            [np.sin(t), np.cos(t), 0],
            [0, 0, 1],
        ])
        xform = np.concatenate([rot, p[:, None]], axis=1)
        xform = _ZUP_TO_YUP @ xform
        xform = ngp_matrix_to_nerf(xform, scale, offset_yup, mitsuba)
        boxes.append({
            "orientation": xform[:3, :3].tolist(),
            "position": xform[:3, 3].tolist(),
            "extents": e.tolist(),
        })
    return boxes


def process_scene(proposal_file, transforms_file, feature_file, output_file,
                  bbox_format="obb", threshold=0.5, top_k=30):
    with open(transforms_file) as f:
        json_dict = json.load(f)
    proposals_dict = np.load(proposal_file)
    features_dict = np.load(feature_file)
    scores = proposals_dict["score"]
    proposals = proposals_dict["proposal"]

    keep = scores > threshold
    scores, proposals = scores[keep], proposals[keep]
    order = np.argsort(-scores)[:top_k]
    scores, proposals = scores[order], proposals[order]

    convert = aabb_proposals_to_ngp if bbox_format == "aabb" else obb_proposals_to_ngp
    boxes = convert(proposals, features_dict)
    for box, s in zip(boxes, scores):
        box["score"] = float(s)
    json_dict["bounding_boxes"] = boxes
    with open(output_file, "w") as f:
        json.dump(json_dict, f, indent=2)
    return len(boxes)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert RPN proposals to instant-ngp transforms.json boxes.")
    p.add_argument("--bbox_format", choices=["aabb", "obb"], required=True)
    p.add_argument("--dataset", required=True, choices=["hypersim", "front3d"])
    p.add_argument("--dataset_path", default="")
    p.add_argument("--features_path", default="")
    p.add_argument("--proposals_path", default="")
    p.add_argument("--output_dir", default="")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--top_k", type=int, default=30)
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    scenes = [
        f[:-4] for f in os.listdir(args.proposals_path) if f.endswith(".npz")
    ]
    for scene in scenes:
        n = process_scene(
            os.path.join(args.proposals_path, scene + ".npz"),
            os.path.join(args.dataset_path, scene, "train", "transforms.json"),
            os.path.join(args.features_path, scene + ".npz"),
            os.path.join(args.output_dir, scene + ".json"),
            args.bbox_format, args.threshold, args.top_k,
        )
        print(f"{scene}: {n} proposals")


if __name__ == "__main__":
    main()
