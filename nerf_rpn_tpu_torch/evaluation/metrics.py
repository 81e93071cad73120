"""Recall / AR / AP of AABB and OBB proposals (host-side numpy).

Copy, for the torch port, of ``nerf_rpn_tpu/evaluation/metrics.py``: the
recall, precision and AP functions of the eval reports
(``cli/common.report_metrics``, ``cli/run_rpn_detect.py``) and the stage-2
classification metrics.
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


def evaluate_box_proposals_precision(
    proposals_list, scores_list, gt_boxes_list,
    score_thresh=0.0, thresholds=None, limit=None,
):
    """Precision over IoU thresholds (reference ``eval.py:84-162``)."""
    box_overlaps = []
    num_det = 0
    for proposals, scores, gt in zip(proposals_list, scores_list, gt_boxes_list):
        keep = scores >= score_thresh
        proposals, scores = proposals[keep], scores[keep]
        order = np.argsort(-scores)
        proposals = proposals[order]
        if proposals.shape[0] == 0:
            continue
        if limit is not None and len(proposals) > limit:
            proposals = proposals[:limit]
        num_det += proposals.shape[0]
        overlaps = _pairwise_iou_np(proposals, gt)
        matched = _greedy_match_overlaps(overlaps, match_axis=1)
        per_box = np.zeros(proposals.shape[0], np.float32)
        per_box[: min(proposals.shape[0], gt.shape[0])] = matched[
            : min(proposals.shape[0], gt.shape[0])
        ]
        box_overlaps.append(per_box)
    box_overlaps = (
        np.concatenate(box_overlaps) if box_overlaps else np.zeros(0, np.float32)
    )
    box_overlaps.sort()
    if thresholds is None:
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05, np.float32)
    thresholds = np.asarray(thresholds, np.float32)
    precisions = np.array(
        [(box_overlaps >= t).sum() / max(num_det, 1) for t in thresholds],
        np.float32,
    )
    return {
        "ap": float(precisions.mean()),
        "precisions": precisions,
        "thresholds": thresholds,
        "num_det": num_det,
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


def evaluate_box_proposals_average_precision(
    proposals_list, scores_list, gt_boxes_list, iou_thresh=0.25, top_k=None
):
    """Confidence-sweep AP variant (reference ``eval.py:228-316``)."""
    box_overlaps, box_scores = [], []
    num_gt = sum(g.shape[0] for g in gt_boxes_list)
    for proposals, scores, gt in zip(proposals_list, scores_list, gt_boxes_list):
        if scores.ndim > 1:
            scores = scores[..., 1]
        order = np.argsort(-scores)
        proposals, scores = proposals[order], scores[order]
        if proposals.shape[0] == 0:
            continue
        if top_k is not None and len(proposals) > top_k:
            proposals, scores = proposals[:top_k], scores[:top_k]
        overlaps = _pairwise_iou_np(proposals, gt)
        n_match = min(proposals.shape[0], gt.shape[0])
        ov = overlaps.copy()
        per_box = np.zeros(proposals.shape[0], np.float32)
        per_score = np.zeros(proposals.shape[0], np.float32)
        for j in range(n_match):
            flat = ov.argmax()
            bi, gi = np.unravel_index(flat, ov.shape)
            per_box[j] = ov[bi, gi]
            per_score[j] = scores[bi]
            ov[bi, :] = -1
            ov[:, gi] = -1
        box_overlaps.append(per_box)
        box_scores.append(per_score)
    box_overlaps = np.concatenate(box_overlaps) if box_overlaps else np.zeros(0)
    box_scores = np.concatenate(box_scores) if box_scores else np.zeros(0)

    conf = np.arange(0.01, 0.99 + 1e-5, 0.01, np.float32)
    precisions = np.zeros_like(conf)
    recalls = np.zeros_like(conf)
    for i, t in enumerate(conf):
        sel = box_scores >= t
        nd = sel.sum()
        hits = (box_overlaps[sel] >= iou_thresh).sum()
        precisions[i] = hits / nd if nd > 0 else 0.0
        recalls[i] = hits / num_gt if num_gt > 0 else 0.0
    ap = float(np.sum((recalls[:-1] - recalls[1:]) * precisions[:-1]))
    return {"ap": ap, "precisions": precisions, "recalls": recalls,
            "thresholds": iou_thresh, "score_thresh": conf}


# ---------------------------------------------------------------------------
# Stage-2 classification metrics (reference eval.py:165-225)
# ---------------------------------------------------------------------------


def evaluate_labels(proposals_list, gt_boxes_list, iou_thresholds=(0.25, 0.5)):
    """Binary gt labels per proposal at each IoU threshold."""
    out = []
    for t in iou_thresholds:
        per_t = []
        for proposals, gt in zip(proposals_list, gt_boxes_list):
            overlaps = _pairwise_iou_np(proposals, gt)
            per_t.append((overlaps.max(1) >= t).astype(np.int32))
        out.append(per_t)
    return out


def evaluate_classification(scores_list, gt_label_list, threshold):
    """Precision / accuracy / precision@100 (reference ``eval.py:193-225``)."""
    precisions, accuracy, precision_100 = [], [], []
    for scores, labels in zip(scores_list, gt_label_list):
        if scores.ndim > 1:
            scores = scores[..., 1]
        top = np.argsort(-scores)[:100]
        precision_100.append(labels[top].sum() / max(len(top), 1))
        pos = scores > threshold
        if pos.sum() > 0:
            precisions.append(labels[pos].sum() / pos.sum())
        accuracy.append((labels == pos.astype(labels.dtype)).mean())
    return {
        "precision": float(np.mean(precisions)) if precisions else 0.0,
        "accuracy": float(np.mean(accuracy)) if accuracy else 0.0,
        "precision_100": float(np.mean(precision_100)) if precision_100 else 0.0,
    }
