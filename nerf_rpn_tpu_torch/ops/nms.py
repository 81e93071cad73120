"""Greedy NMS as a bitmask fixpoint (port of ``ops/nms.py:113-281``).

Batched over independent problems (the RPN runs one per (scene, level)):

1. order each problem's boxes by descending score, stable (lowest index
   first on ties), with invalid entries scored ``NEG_INF`` -- the order of
   ``argsort(-masked)`` in the JAX package;
2. pad to a multiple of 256 with zero boxes that are never valid;
3. build the packed suppression graph: bit c of word w in row j is set iff
   ``32w + c < j`` and ``IoU(j, 32w + c) > iou_threshold``.  AABBs (P, N,
   6) take kernel K3 (``ops/nms_graph.aabb_suppression_graph``); OBBs (P,
   N, 7) take ``obb_suppression_graph``, plain torch on every device (the
   JAX package has no Pallas kernel for the rotated geometry);
4. take the fixpoint of ``alive <- valid & ~any(graph & packed(alive))``,
   which equals sequential greedy NMS (a box is suppressed iff an earlier
   *kept* box overlaps it past the threshold), with
   ``ops/nms_graph.resolve_keep``: on CUDA tensors the resolve kernel, one
   launch and no host sync; on CPU tensors the sweep loop.

The AABB path makes no host sync.  The OBB graph build makes one per row
chunk: the ``nonzero`` that compacts the gated pairs.
"""

from __future__ import annotations

import torch

from nerf_rpn_tpu_torch.ops.nms_graph import WORD, aabb_suppression_graph, pack_bits, resolve_keep
from nerf_rpn_tpu_torch.ops.rotated_iou_pairwise import (
    iou_rotated_3d_pairs_soa,
    iou_rotated_3d_upper_bound,
)
from nerf_rpn_tpu_torch.ops.topk import safe_top_k

NEG_INF = -1e10
PAD_MULTIPLE = 256
# OBB graph build: rows a chunk (bounds the (P, rows, Np) gate tensors) and
# gated pairs a clipping batch (bounds the (pairs, 24) vertex tensors)
ROW_CHUNK = 512
PAIR_BATCH = 1 << 18
# the gate's slack: the bound's and the clipping's f32 arithmetic differ by
# < 1e-5 on random boxes
GATE_SLACK = 1e-3


def sort_problems(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor):
    """Steps 1-2: ``(order (P, N), sboxes (P, Np, D) f32, svalid (P, Np))``
    -- each problem's boxes (D = 6 or 7) in descending score order
    (stable), padded to a multiple of ``PAD_MULTIPLE`` with zero boxes that
    are never valid."""
    p, n = scores.shape
    masked = torch.where(valid, scores, NEG_INF)
    order = torch.sort(-masked, dim=-1, stable=True).indices
    sboxes = torch.gather(boxes, 1, order[..., None].expand(p, n, boxes.shape[-1]))
    svalid = torch.gather(valid, 1, order)
    pad = (-n) % PAD_MULTIPLE
    sboxes = torch.nn.functional.pad(sboxes.float(), (0, 0, 0, pad))
    svalid = torch.nn.functional.pad(svalid, (0, pad))
    return order, sboxes, svalid


def gated_pairs(boxes: torch.Tensor, r0: int, r1: int,
                iou_threshold: float) -> torch.Tensor:
    """(K, 3) int64 ``(problem, row - r0, column)`` of the pairs below the
    diagonal in rows ``r0:r1`` of the score-sorted (P, Np, 7) OBBs whose
    IoU bound clears ``iou_threshold - GATE_SLACK`` (``nonzero``: a host
    sync)."""
    pos = torch.arange(r1, device=boxes.device)
    earlier = pos[None, :] < pos[r0:r1, None]                           # (C, r1)
    ub = iou_rotated_3d_upper_bound(boxes[:, r0:r1], boxes[:, :r1])     # (P, C, r1)
    return (earlier & (ub > iou_threshold - GATE_SLACK)).nonzero()


def obb_suppression_graph(boxes: torch.Tensor, iou_threshold: float,
                          row_chunk: int = ROW_CHUNK, pair_batch: int = PAIR_BATCH,
                          stats: dict | None = None) -> torch.Tensor:
    """(P, Np, 7) f32 score-sorted OBBs, Np a multiple of 32 -> int32 (P,
    Np, Np/32) suppression graph, the words K3 builds for AABBs.

    Rows go in chunks of ``row_chunk`` against the columns before the
    chunk's end; ``gated_pairs`` gates and compacts each chunk's pairs (a
    host sync a chunk), which are clipped exactly in batches of
    ``pair_batch``.  The bits depend on neither size,
    only the time and memory do.  ``stats``, if given, receives ``pairs``
    (pairs below the diagonal), ``gated`` (pairs clipped) and ``syncs``.
    """
    p, np_, d = boxes.shape
    if d != 7 or np_ % WORD or row_chunk % WORD:
        raise ValueError(f"boxes must be (P, Np, 7) with Np and row_chunk multiples of "
                         f"{WORD}, got {tuple(boxes.shape)} and {row_chunk}")
    graph = torch.zeros((p, np_, np_ // WORD), dtype=torch.int32, device=boxes.device)
    gated = syncs = 0
    for r0 in range(0, np_, row_chunk):
        r1 = min(r0 + row_chunk, np_)
        idx = gated_pairs(boxes, r0, r1, iou_threshold)
        syncs += 1
        gated += idx.shape[0]
        hit = torch.zeros((p, r1 - r0, r1), dtype=torch.bool, device=boxes.device)
        for s in range(0, idx.shape[0], pair_batch):
            pi, ri, ci = idx[s:s + pair_batch].unbind(1)
            iou = iou_rotated_3d_pairs_soa(boxes[pi, r0 + ri], boxes[pi, ci])
            hit[pi, ri, ci] = iou > iou_threshold
        graph[:, r0:r1, :r1 // WORD] = pack_bits(hit)
    if stats is not None:
        stats.update(pairs=p * np_ * (np_ - 1) // 2, gated=gated, syncs=syncs)
    return graph


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep-mask with exact sequential semantics.

    Args:
        boxes: (P, N, 6) AABBs or (P, N, 7) OBBs (any float dtype; the
            graph is built in f32).
        scores: (P, N).
        valid: (P, N) bool; invalid entries are never kept and never
            suppress.
        iou_threshold: suppress when IoU > threshold (strict).

    Returns:
        keep: (P, N) bool in the original order.
    """
    order, sboxes, svalid = sort_problems(boxes, scores, valid)
    if boxes.shape[-1] == 6:
        graph = aabb_suppression_graph(sboxes, iou_threshold)  # (P, Np, Np/32)
    else:
        graph = obb_suppression_graph(sboxes, iou_threshold)
    alive = resolve_keep(graph, svalid)
    keep = torch.zeros_like(valid)
    keep.scatter_(1, order, alive[:, :scores.shape[1]])
    return keep


def topk_after_nms(scores: torch.Tensor, keep: torch.Tensor, k: int):
    """Indices of the k highest-scored kept boxes, and their validity."""
    masked = torch.where(keep, scores, NEG_INF)
    vals, idx = safe_top_k(masked, k)
    return idx, vals > NEG_INF / 2
