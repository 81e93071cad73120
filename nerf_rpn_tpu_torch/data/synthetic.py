"""Synthetic rgbsigma scenes with planted boxes, for train-to-quality gates.

The reference repo's de-facto acceptance test is training on real rgbsigma
extractions and comparing eval.json against the paper's tables (reference
``run_rpn.py:533-583``; released weights in ``README.md:46-50``).  Real data
and released weights are not available in this environment, so this module
generates the stand-in: scenes whose density/color signal is perfectly
box-correlated, on which a correctly-wired detector must reach near-perfect
AP@0.25 from scratch.  A bug in target assignment, box coding, loss
weighting, or NMS that still lets the loss decrease will fail the gate.

Scene recipe (per scene):
- 1..``max_boxes`` non-overlapping boxes, side lengths uniform in
  ``box_size``; OBB mode rotates each box about +z by a uniform theta so the
  regression target carries angle information.
- density channel: ~1 inside each box, ~0 outside, plus additive noise and a
  handful of high-density distractor voxels (so "density > t" alone is not a
  detector).
- rgb channels: a random per-box color inside, gray background.

File layout matches the drivers' dataset contract (``data/datasets.py``):
``{name}.npz`` with ``rgbsigma (W, L, H, 4)`` float32 (already alpha-like:
drivers should NOT pass --normalize_density), ``{name}.npy`` boxes
``(N, 6|7)``, and ``split.npz`` with train/val/test scene-name arrays.
"""

from __future__ import annotations

import os

import numpy as np


def _rasterize_aabb(mask, box):
    x1, y1, z1, x2, y2, z2 = box
    lo = np.floor([x1, y1, z1]).astype(int)
    hi = np.ceil([x2, y2, z2]).astype(int)
    lo = np.clip(lo, 0, None)
    mask[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = True


def _rasterize_obb(mask, box):
    """Voxel-center point-in-rotated-box test (theta about +z, radians)."""
    x, y, z, w, l, h, theta = box
    res = mask.shape
    xs = np.arange(res[0]) + 0.5
    ys = np.arange(res[1]) + 0.5
    zs = np.arange(res[2]) + 0.5
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    c, s = np.cos(-theta), np.sin(-theta)
    dx, dy, dz = gx - x, gy - y, gz - z
    rx = c * dx - s * dy
    ry = s * dx + c * dy
    inside = ((np.abs(rx) <= w / 2) & (np.abs(ry) <= l / 2)
              & (np.abs(dz) <= h / 2))
    mask |= inside


def _boxes_overlap_aabb(a, b, margin=1.0):
    return bool(np.all(a[:3] - margin < b[3:6]) and np.all(b[:3] - margin < a[3:6]))


def generate_scene(rng, resolution=(32, 32, 32), max_boxes=3,
                   box_size=(8.0, 18.0), rotated=False, noise=0.05,
                   n_distractors=12):
    """Returns (rgbsigma (W, L, H, 4) float32, boxes (N, 6|7) float32)."""
    res = np.asarray(resolution)
    n = int(rng.integers(1, max_boxes + 1))
    boxes, aabbs = [], []
    for _ in range(32):
        if len(boxes) >= n:
            break
        size = rng.uniform(*box_size, 3)
        ctr = rng.uniform(size / 2 + 1, res - size / 2 - 1)
        # conservative overlap check in AABB space (circumscribed for OBB)
        r = (np.hypot(size[0], size[1]) if rotated else max(size[:2])) / 2
        cand = np.concatenate([ctr - [r, r, size[2] / 2],
                               ctr + [r, r, size[2] / 2]])
        if any(_boxes_overlap_aabb(cand, a) for a in aabbs):
            continue
        aabbs.append(cand)
        if rotated:
            theta = rng.uniform(-np.pi / 2, np.pi / 2)
            boxes.append(np.concatenate([ctr, size, [theta]]))
        else:
            boxes.append(np.concatenate([ctr - size / 2, ctr + size / 2]))

    rgbsigma = np.empty((*resolution, 4), np.float32)
    rgbsigma[..., :3] = 0.3
    rgbsigma[..., 3] = 0.0
    for box in boxes:
        mask = np.zeros(resolution, bool)
        (_rasterize_obb if rotated else _rasterize_aabb)(mask, box)
        rgbsigma[mask, :3] = rng.uniform(0.5, 1.0, 3)
        rgbsigma[mask, 3] = rng.uniform(0.85, 1.0)
    if noise > 0:
        rgbsigma += rng.normal(0, noise, rgbsigma.shape).astype(np.float32)
    # distractors: isolated hot voxels that are NOT boxes
    for _ in range(n_distractors):
        p = rng.integers(0, res)
        rgbsigma[p[0], p[1], p[2], 3] = rng.uniform(0.8, 1.0)
    rgbsigma = np.clip(rgbsigma, 0.0, 1.0)
    return rgbsigma, np.asarray(boxes, np.float32)


def _iou_aabb_np(a, b):
    lo = np.maximum(a[:3], b[:3])
    hi = np.minimum(a[3:6], b[3:6])
    inter = np.prod(np.clip(hi - lo, 0, None))
    va = np.prod(a[3:6] - a[:3])
    vb = np.prod(b[3:6] - b[:3])
    return inter / max(va + vb - inter, 1e-9)


def write_synthetic_rois(data_dir, roi_dir, resolution=(32, 32, 32),
                         pos_per_gt=3, n_neg=8, jitter=1.5, seed=0):
    """Stage-2 inputs for the RCNN quality gate: per-scene proposal npz.

    For every ``{name}.npy`` AABB gt file in ``data_dir``, writes
    ``{name}.npz`` in ``roi_dir`` with ``proposals`` (R, 6) and
    ``level_indices`` (R,) int32 — the stage-1 ``--output_proposals`` dump
    contract the RCNN driver consumes (``data/datasets.py::
    RPNClassificationDataset``).  Positives are gt boxes with corners
    jittered by up to ``jitter`` voxels (IoU ~0.5-0.9 -> foreground under
    the default 0.35 threshold); negatives are rejection-sampled random
    boxes with IoU < 0.1 against every gt.  A correctly-wired second stage
    must separate them near-perfectly and refine the positives back onto
    the gt.
    """
    os.makedirs(roi_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    res = np.asarray(resolution, np.float32)
    for fn in sorted(os.listdir(data_dir)):
        if not fn.endswith(".npy"):
            continue
        gt = np.load(os.path.join(data_dir, fn)).astype(np.float32)
        assert gt.shape[1] == 6, "rcnn gate is AABB-only"
        rois = []
        for box in gt:
            for _ in range(pos_per_gt):
                r = box + rng.uniform(-jitter, jitter, 6)
                lo = np.minimum(r[:3], r[3:] - 1.0)
                rois.append(np.concatenate([np.clip(lo, 0, None),
                                            np.minimum(r[3:], res)]))
        negs = 0
        while negs < n_neg:
            size = rng.uniform(3, 9, 3)
            lo = rng.uniform(0, res - size)
            cand = np.concatenate([lo, lo + size]).astype(np.float32)
            if all(_iou_aabb_np(cand, g) < 0.1 for g in gt):
                rois.append(cand)
                negs += 1
        rois = np.asarray(rois, np.float32)
        np.savez(os.path.join(roi_dir, fn[:-len(".npy")] + ".npz"),
                 proposals=rois,
                 level_indices=np.zeros((len(rois),), np.int32))


def write_synthetic_dataset(out_dir, n_train=24, n_val=4, n_test=8,
                            resolution=(32, 32, 32), rotated=False,
                            max_boxes=3, box_size=(8.0, 18.0), seed=0):
    """Generate a full driver-consumable dataset; returns the split dict."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = [f"synth{i:03d}" for i in range(n_train + n_val + n_test)]
    for name in names:
        rgbsigma, boxes = generate_scene(
            rng, resolution, max_boxes=max_boxes, box_size=box_size,
            rotated=rotated)
        np.savez(os.path.join(out_dir, f"{name}.npz"), rgbsigma=rgbsigma)
        np.save(os.path.join(out_dir, f"{name}.npy"), boxes)
    split = {
        "train_scenes": np.array(names[:n_train]),
        "val_scenes": np.array(names[n_train:n_train + n_val]),
        "test_scenes": np.array(names[n_train + n_val:]),
    }
    np.savez(os.path.join(out_dir, "split.npz"), **split)
    return split
