"""Greedy NMS as a bitmask fixpoint, AABB path (port of ``ops/nms.py:113-281``).

Batched over independent problems (the RPN runs one per (scene, level)):

1. order each problem's boxes by descending score, stable (lowest index
   first on ties), with invalid entries scored ``NEG_INF`` -- the order of
   ``argsort(-masked)`` in the JAX package;
2. pad to a multiple of 256 with zero boxes that are never valid;
3. build the packed suppression graph with kernel K3
   (``ops/nms_graph.aabb_suppression_graph``);
4. take the fixpoint of ``alive <- valid & ~any(graph & packed(alive))``,
   which equals sequential greedy NMS (a box is suppressed iff an earlier
   *kept* box overlaps it past the threshold), with
   ``ops/nms_graph.resolve_keep``: on CUDA tensors the resolve kernel, one
   launch and no host sync; on CPU tensors the sweep loop.

The rotated (OBB) path with its gated polygon clipping is not ported yet.
"""

from __future__ import annotations

import torch

from nerf_rpn_tpu_torch.ops.nms_graph import aabb_suppression_graph, resolve_keep
from nerf_rpn_tpu_torch.ops.topk import safe_top_k

NEG_INF = -1e10
PAD_MULTIPLE = 256


def sort_problems(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor):
    """Steps 1-2: ``(order (P, N), sboxes (P, Np, 6) f32, svalid (P, Np))``
    -- each problem's boxes in descending score order (stable), padded to a
    multiple of ``PAD_MULTIPLE`` with zero boxes that are never valid."""
    p, n = scores.shape
    masked = torch.where(valid, scores, NEG_INF)
    order = torch.sort(-masked, dim=-1, stable=True).indices
    sboxes = torch.gather(boxes, 1, order[..., None].expand(p, n, 6))
    svalid = torch.gather(valid, 1, order)
    pad = (-n) % PAD_MULTIPLE
    sboxes = torch.nn.functional.pad(sboxes.float(), (0, 0, 0, pad))
    svalid = torch.nn.functional.pad(svalid, (0, pad))
    return order, sboxes, svalid


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep-mask with exact sequential semantics.

    Args:
        boxes: (P, N, 6) AABBs (any float dtype; the graph is built in f32).
        scores: (P, N).
        valid: (P, N) bool; invalid entries are never kept and never
            suppress.
        iou_threshold: suppress when IoU > threshold (strict).

    Returns:
        keep: (P, N) bool in the original order.
    """
    if boxes.shape[-1] != 6:
        raise NotImplementedError("only the AABB (N, 6) path is ported")
    order, sboxes, svalid = sort_problems(boxes, scores, valid)
    graph = aabb_suppression_graph(sboxes, iou_threshold)  # (P, Np, Np/32)
    alive = resolve_keep(graph, svalid)
    keep = torch.zeros_like(valid)
    keep.scatter_(1, order, alive[:, :scores.shape[1]])
    return keep


def topk_after_nms(scores: torch.Tensor, keep: torch.Tensor, k: int):
    """Indices of the k highest-scored kept boxes, and their validity."""
    masked = torch.where(keep, scores, NEG_INF)
    vals, idx = safe_top_k(masked, k)
    return idx, vals > NEG_INF / 2
