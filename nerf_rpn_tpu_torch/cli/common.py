"""CLI plumbing of the torch port: logging, datasets, eval reporting, dumps.

Copy, for the torch port, of the functions of ``nerf_rpn_tpu/cli/common.py``
that ``cli/run_rpn.py`` and ``cli/run_fcos.py`` call, the batch copy of
their train steps (``device_batch``) and the timing of their ``--mode
benchmark`` (``benchmark_eval_step``).  They mirror the driver plumbing
the reference repeats in each run_*.py: loggers with optional file handlers
(``run_rpn.py:627-642``), dataset construction by name + split file
(``run_rpn.py:250-267,310-330``), proposal/voxel-score npz dumps
(``run_rpn.py:432-453,476-481``) and the Recall/AR/AP report +
``eval.json`` (``run_rpn.py:533-583``).  wandb is refused by the port's
CLI, so the report logs no wandb run.
"""

from __future__ import annotations

import json
import logging
import os
import sys

import numpy as np
import torch

from nerf_rpn_tpu_torch.data.datasets import (
    Front3DRPNDataset,
    GeneralRPNDataset,
    HypersimRPNDataset,
    ScanNetRPNDataset,
    load_split,
)
from nerf_rpn_tpu_torch.evaluation.metrics import (
    _pairwise_iou_np,
    evaluate_box_proposals_ap,
    evaluate_box_proposals_recall,
)


def setup_logger(save_path: str = "", log_to_file: bool = False,
                 name: str = "nerf_rpn_tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(sh)
    if log_to_file and save_path:
        os.makedirs(save_path, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_path, f"{name}.log"))
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(fh)
    return logger


def build_datasets(args, mode: str, augment: bool):
    """Returns (train_set, val_set, test_set) — unused slots are None."""
    name = getattr(args, "dataset_name", None) or getattr(args, "dataset")
    aug = dict(
        flip_prob=args.flip_prob if augment else 0.0,
        rotate_prob=args.rotate_prob if augment else 0.0,
        rot_scale_prob=args.rot_scale_prob if augment else 0.0,
    )
    if name == "general":
        train_set = val_set = test_set = None
        if mode == "train":
            train_set = GeneralRPNDataset(args.train_csv, args.normalize_density, **aug)
            val_set = GeneralRPNDataset(args.val_csv, args.normalize_density)
        else:
            test_set = GeneralRPNDataset(args.test_csv, args.normalize_density)
        return train_set, val_set, test_set

    cls = {
        "hypersim": HypersimRPNDataset,
        "front3d": Front3DRPNDataset,
        "scannet": ScanNetRPNDataset,
    }[name]
    train_scenes, val_scenes, test_scenes = load_split(args.dataset_split)

    def make(scenes, with_aug):
        kw = dict(**(aug if with_aug else {}))
        if name == "scannet":
            return cls(scenes, args.features_path, args.boxes_path, **kw)
        return cls(
            args.features_path, args.boxes_path, scene_list=scenes,
            normalize_density=args.normalize_density,
            preload=getattr(args, "preload", False), **kw,
        )

    if mode == "train":
        return make(train_scenes, True), make(val_scenes, False), None
    return None, None, make(test_scenes, False)


def eval_datasets(args, evaluate):
    """``--mode eval``: ``evaluate(test_set)``, or with ``--output_all``
    ``evaluate`` on the train, validation and test scenes in turn (each
    writes its report and dumps over the last); returns the last result."""
    if not args.output_all:
        return evaluate(build_datasets(args, "eval", augment=False)[2])
    train_set, val_set, _ = build_datasets(args, "train", augment=False)
    _, _, test_set = build_datasets(args, "eval", augment=False)
    result = None
    for ds in (train_set, val_set, test_set):
        if ds is not None and len(ds):
            result = evaluate(ds)
    return result


def device_batch(batch: dict, device: torch.device, dtype: torch.dtype) -> dict:
    """Host batch (numpy) -> a train step's device tensors, the grids in
    the compute dtype."""
    return {
        "grids": torch.from_numpy(batch["grids"]).to(device, dtype),
        "ori_sizes": torch.from_numpy(batch["ori_sizes"]).to(device),
        "gt_boxes": torch.from_numpy(batch["gt_boxes"]).to(device),
        "gt_mask": torch.from_numpy(batch["gt_mask"]).to(device),
    }


def unmask_proposals(out: dict, box_dim: int):
    """Fixed-shape device outputs -> per-scene variable-length numpy lists.

    Always float32 on the host: under ``--bf16`` the device outputs are
    bfloat16, which plain-numpy consumers of the dumped npz files
    (np.isfinite, downstream tools without ml_dtypes) cannot ingest."""
    boxes = np.asarray(out["boxes"]).astype(np.float32, copy=False)
    scores = np.asarray(out["scores"]).astype(np.float32, copy=False)
    valid = np.asarray(out["valid"])
    levels = np.asarray(out["level_idx"])
    props, scs, lvls = [], [], []
    for i in range(boxes.shape[0]):
        v = valid[i]
        props.append(boxes[i][v][:, :box_dim])
        scs.append(scores[i][v])
        lvls.append(levels[i][v])
    return props, scs, lvls


def output_proposals_npz(save_path, scenes, proposals, scores, gt_boxes,
                         filter_mode="none", filter_threshold=0.7,
                         level_indices=None):
    """Per-scene proposals npz with optional tp/fp filtering
    (reference ``output_proposals``, ``run_rpn.py:432-453``)."""
    out_dir = os.path.join(save_path, "proposals")
    os.makedirs(out_dir, exist_ok=True)
    for i, (scene, proposal, score) in enumerate(zip(scenes, proposals, scores)):
        gt = gt_boxes[i] if gt_boxes is not None else None
        keep = np.ones(len(proposal), bool)
        if filter_mode != "none":
            if len(proposal) == 0 or gt is None or len(gt) == 0:
                print(f"No proposals or GT for {scene}")
                continue
            iou = _pairwise_iou_np(gt, proposal)
            keep = iou.max(0) > filter_threshold
            if filter_mode == "fp":
                keep = ~keep
        payload = {"proposal": proposal[keep], "score": score[keep]}
        if level_indices is not None:
            payload["level_indices"] = level_indices[i][keep]
        np.savez(os.path.join(out_dir, f"{scene}.npz"), **payload)


def output_voxel_scores_npz(save_path, scene, per_level_scores, ori_size, strides):
    """Crop per-level voxel scores to ceil(ori/stride) and save
    (reference ``output_objectness``, ``rpn.py:538-549``)."""
    scores_dir = os.path.join(save_path, "voxel_scores")
    os.makedirs(scores_dir, exist_ok=True)
    all_levels = {}
    for level, score in enumerate(per_level_scores):
        w, l, h = np.ceil(np.asarray(ori_size) / strides[level]).astype(int)
        # float32 at the host boundary (bf16 npz breaks plain-numpy readers)
        all_levels[str(level)] = (
            np.asarray(score)[:w, :l, :h].astype(np.float32, copy=False))
    np.savez_compressed(os.path.join(scores_dir, f"{scene}.npz"), **all_levels)


def report_metrics(proposals_list, scores_list, gt_boxes_list, args, logger,
                   post_nms_top_n, write_json=True):
    """Recall@50/@25 + AR at top-{300, 1000, post_nms_top_n}, AP@50/AP@25,
    eval.json dump (reference ``run_rpn.py:533-583``)."""
    recalls, aps = [], []
    json_dict = {}
    for limit in [300, 1000, post_nms_top_n]:
        if limit > post_nms_top_n:
            continue
        r50 = evaluate_box_proposals_recall(
            proposals_list, scores_list, gt_boxes_list, thresholds=[0.5], limit=limit)
        r25 = evaluate_box_proposals_recall(
            proposals_list, scores_list, gt_boxes_list, thresholds=[0.25], limit=limit)
        ar = evaluate_box_proposals_recall(
            proposals_list, scores_list, gt_boxes_list,
            thresholds=np.arange(0.25, 1.0, 0.05), limit=limit)
        recalls.append(r50["ar"])
        json_dict[f"recall_50_top_{limit}"] = r50
        json_dict[f"recall_25_top_{limit}"] = r25
        json_dict[f"recall_ar_top_{limit}"] = ar
        logger.info(f"Top {limit}: Recall@50 {r50['ar']:.4f}  "
                    f"Recall@25 {r25['ar']:.4f}  AR {ar['ar']:.4f}  "
                    f"(num_pos {r50['num_pos']})")

    top_k = getattr(args, "top_k", None) or getattr(args, "ap_top_n", None)
    ap50 = evaluate_box_proposals_ap(
        proposals_list, scores_list, gt_boxes_list, iou_thresh=0.5, top_k=top_k)
    ap25 = evaluate_box_proposals_ap(
        proposals_list, scores_list, gt_boxes_list, iou_thresh=0.25, top_k=top_k)
    aps.append(ap50["ap"])
    json_dict["ap_50"] = ap50
    json_dict["ap_25"] = ap25
    logger.info(f"AP@50: {ap50['ap']:.4f}  AP@25: {ap25['ap']:.4f}")

    if write_json and args.save_path:
        os.makedirs(args.save_path, exist_ok=True)
        clean = {
            k: {kk: (vv.tolist() if isinstance(vv, np.ndarray) else vv)
                for kk, vv in v.items()}
            for k, v in json_dict.items()
        }
        with open(os.path.join(args.save_path, "eval.json"), "w") as f:
            json.dump(clean, f, indent=2)
    return recalls, aps


def benchmark_eval_step(forward, propose, reps: int, warmup: int, logger,
                        device: torch.device) -> dict:
    """Time ``propose(*forward())`` on the card: ``warmup`` untimed calls,
    then ``reps`` calls with CUDA events around the forward and the propose
    part, after ``torch.cuda.synchronize()``.  Logs and returns the mean
    device ms a scene of each part and of the whole, the median and the
    highest percentile with >= 10 samples above it, and the valid
    proposals of the last call."""
    for _ in range(warmup):
        propose(*forward())
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(reps)]
    torch.cuda.synchronize()
    for ev in events:
        ev[0].record()
        heads = forward()
        ev[1].record()
        out = propose(*heads)
        ev[2].record()
    torch.cuda.synchronize()
    fwd = np.array([a.elapsed_time(b) for a, b, _ in events])
    prop = np.array([b.elapsed_time(c) for _, b, c in events])
    total = np.array([a.elapsed_time(c) for a, _, c in events])
    pct = 100.0 * (1.0 - 10.0 / reps)
    logger.info(
        f"Average inference time on {torch.cuda.get_device_name(device)}: "
        f"{total.mean():.4f} ms ({1e3 / total.mean():.2f} scenes/sec); forward "
        f"{fwd.mean():.4f} ms, propose {prop.mean():.4f} ms; median "
        f"{np.median(total):.4f} ms, p{pct:.1f} {np.percentile(total, pct):.4f} ms "
        f"over {reps} scenes")
    return {"forward_ms": float(fwd.mean()), "propose_ms": float(prop.mean()),
            "total_ms": float(total.mean()), "total_median_ms": float(np.median(total)),
            "tail_percentile": pct, "total_tail_ms": float(np.percentile(total, pct)),
            "reps": reps, "warmup": warmup, "valid_proposals": int(out["valid"].sum())}
