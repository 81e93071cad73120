"""Recall / AR / AP of AABB and OBB proposals (host-side numpy).

Copy, for the torch port, of the part of
``nerf_rpn_tpu/evaluation/metrics.py`` that the eval report
(``cli/common.report_metrics``) and the proposal filter call.
Parity target: reference ``nerf_rpn/eval.py`` -- Detectron-style greedy
one-to-one matching for recall (:14-81) and VOC AP with the precision
envelope + delta-recall summation (:319-395).  The IoU of oriented
(7-wide) boxes is ``ops/rotated_iou_pairwise``'s, on CPU tensors.

Inputs are python lists of per-scene numpy arrays (variable length -- eval
runs after the fixed-shape device pipeline has been unmasked).
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_rpn_tpu_torch.ops.rotated_iou_pairwise import pairwise_iou_rotated_3d_soa


def _pairwise_iou_np(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """(M, 6|7) x (N, 6|7) -> (M, N); AABB in numpy, OBB in torch on the CPU."""
    if boxes1.shape[-1] == 6:
        lt = np.maximum(boxes1[:, None, :3], boxes2[None, :, :3])
        rb = np.minimum(boxes1[:, None, 3:], boxes2[None, :, 3:])
        whd = np.clip(rb - lt, 0, None)
        inter = whd.prod(-1)
        v1 = (boxes1[:, 3:] - boxes1[:, :3]).prod(-1)
        v2 = (boxes2[:, 3:] - boxes2[:, :3]).prod(-1)
        return inter / (v1[:, None] + v2[None, :] - inter)
    return pairwise_iou_rotated_3d_soa(
        torch.from_numpy(np.ascontiguousarray(boxes1, np.float32)),
        torch.from_numpy(np.ascontiguousarray(boxes2, np.float32))).numpy()


def _greedy_match_overlaps(overlaps: np.ndarray, match_axis: int) -> np.ndarray:
    """Detectron greedy one-to-one matching.

    match_axis=0: for each gt (columns are gt), record the best proposal IoU
    (recall flavour, output per-gt).  match_axis=1: record per-proposal IoU
    (precision flavour, output per-proposal, in pick order).
    """
    overlaps = overlaps.copy()
    m, n = overlaps.shape
    steps = min(m, n)
    out = np.zeros(n if match_axis == 0 else m, np.float32)
    for j in range(steps):
        flat = overlaps.argmax()
        bi, gi = np.unravel_index(flat, overlaps.shape)
        val = overlaps[bi, gi]
        out[j] = val
        overlaps[bi, :] = -1
        overlaps[:, gi] = -1
    return out


def evaluate_box_proposals_recall(
    proposals_list, scores_list, gt_boxes_list, thresholds=None, limit=None
):
    """Recall over IoU thresholds + AR (reference ``eval.py:14-81``)."""
    gt_overlaps = []
    num_pos = 0
    for proposals, scores, gt in zip(proposals_list, scores_list, gt_boxes_list):
        order = np.argsort(-scores)
        proposals = proposals[order]
        if proposals.shape[0] == 0 or gt.shape[0] == 0:
            continue
        num_pos += gt.shape[0]
        if limit is not None and len(proposals) > limit:
            proposals = proposals[:limit]
        overlaps = _pairwise_iou_np(proposals, gt)
        matched = _greedy_match_overlaps(overlaps, match_axis=0)
        per_gt = np.zeros(gt.shape[0], np.float32)
        per_gt[: min(proposals.shape[0], gt.shape[0])] = matched[
            : min(proposals.shape[0], gt.shape[0])
        ]
        gt_overlaps.append(per_gt)
    gt_overlaps = (
        np.concatenate(gt_overlaps) if gt_overlaps else np.zeros(0, np.float32)
    )
    gt_overlaps.sort()
    if thresholds is None:
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05, np.float32)
    thresholds = np.asarray(thresholds, np.float32)
    recalls = np.array(
        [(gt_overlaps >= t).sum() / max(num_pos, 1) for t in thresholds],
        np.float32,
    )
    return {
        "ar": float(recalls.mean()),
        "recalls": recalls,
        "thresholds": thresholds,
        "gt_overlaps": gt_overlaps,
        "num_pos": num_pos,
    }


def evaluate_box_proposals_ap(
    proposals_list, scores_list, gt_boxes_list, iou_thresh=0.25, top_k=None
):
    """PASCAL VOC AP (reference ``eval.py:319-395``): global score-sorted
    sweep, greedy first-hit gt matching, precision envelope."""
    num_gt = sum(g.shape[0] for g in gt_boxes_list)
    scene_ids, dets, scores = [], [], []
    for i, (p, s) in enumerate(zip(proposals_list, scores_list)):
        if top_k is not None and len(p) > top_k:
            order = np.argsort(-s)[:top_k]
            p, s = p[order], s[order]
        scene_ids.extend([i] * len(p))
        dets.append(p)
        scores.append(s)
    if not dets or num_gt == 0:
        return {"ap": 0.0, "precisions": np.zeros(0), "recalls": np.zeros(0)}
    dets = np.concatenate(dets)
    scores = np.concatenate(scores)
    scene_ids = np.asarray(scene_ids)
    order = np.argsort(-scores)
    dets, scene_ids = dets[order], scene_ids[order]

    # per-scene IoU matrices once (avoids the reference's per-detection call)
    iou_by_scene = {}
    for i, gt in enumerate(gt_boxes_list):
        sel = scene_ids == i
        if sel.any() and gt.shape[0] > 0:
            iou_by_scene[i] = _pairwise_iou_np(dets[sel], gt)

    ptr = {i: 0 for i in range(len(gt_boxes_list))}
    gt_used = [np.zeros(g.shape[0], bool) for g in gt_boxes_list]
    tp = np.zeros(len(dets), bool)
    for d in range(len(dets)):
        sid = int(scene_ids[d])
        gt = gt_boxes_list[sid]
        if gt.shape[0] == 0:
            continue
        row = iou_by_scene[sid][ptr[sid]]
        ptr[sid] += 1
        gi = int(row.argmax())
        if row[gi] > iou_thresh and not gt_used[sid][gi]:
            tp[d] = True
            gt_used[sid][gi] = True
    tpc = np.cumsum(tp)
    fpc = np.cumsum(~tp)
    recalls = tpc / num_gt
    precisions = tpc / np.maximum(tpc + fpc, 1)

    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    ap = float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    return {"ap": ap, "precisions": precisions, "recalls": recalls,
            "thresholds": iou_thresh, "num_det": tpc + fpc}
