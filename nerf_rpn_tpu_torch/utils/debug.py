"""Debug instrumentation.

``inspect_anchor_gt_iou`` mirrors the reference's
``vis_iou_of_anchor_and_gt`` (``model/utils.py:461-496``): per-scene
statistics of the best anchor IoU per gt box and the fg/bg anchor counts at
the matcher thresholds — the first thing to look at when recall is zero.
The torch port of ``nerf_rpn_tpu/utils/debug.py``: the same printed lines
and returned statistics, the IoUs computed on ``device`` (the GPU unless
the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_rpn_tpu_torch.device import resolve_device
from nerf_rpn_tpu_torch.ops.aabb import pairwise_iou_aabb
from nerf_rpn_tpu_torch.ops.obb import obb2hbb_3d


@torch.no_grad()
def inspect_anchor_gt_iou(anchors, targets_list, pos_thres=0.7, neg_thres=0.3,
                          print_fn=print, device="cuda"):
    """anchors: (N, 6) tensor or array; targets_list: list of per-scene
    (G, 6|7) numpy.  Both are moved to ``device``, which defaults to the GPU
    and raises without one."""
    dev = resolve_device(device)
    title = "#" * 40 + " IOU of anchors and GT " + "#" * 40
    print_fn(title)
    stats = []
    anchors = torch.as_tensor(anchors).to(dev)
    for mesh_idx, target in enumerate(targets_list):
        print_fn(f"Checking IOU of mesh {mesh_idx}...")
        t = torch.as_tensor(np.asarray(target, np.float32), device=dev)
        if t.shape[-1] == 7:
            t = obb2hbb_3d(t)
        ious = pairwise_iou_aabb(anchors, t)  # (N, G)
        best_per_gt, best_anchor = (v.cpu().numpy() for v in ious.max(dim=0))
        for g in range(len(best_per_gt)):
            print_fn(
                f"\ttarget={np.asarray(target)[g]}, iou={best_per_gt[g]:.3f}, "
                f"best_match={anchors[int(best_anchor[g])].cpu().numpy()}")
        per_anchor = ious.max(dim=1).values
        n_pos = int((per_anchor > pos_thres).sum())
        n_neg = int((per_anchor < neg_thres).sum())
        print_fn(f"\tmean_iou={best_per_gt.mean():.4f}")
        print_fn(f"\tnum_pos_anchors={n_pos}\n\tnum_neg_anchors={n_neg}")
        stats.append({
            "mean_best_iou": float(best_per_gt.mean()),
            "num_pos_anchors": n_pos,
            "num_neg_anchors": n_neg,
        })
    print_fn("#" * len(title))
    return stats
