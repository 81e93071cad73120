"""Packed AABB suppression graph (kernel K3) and its resolve kernel, with twins.

Port of ``suppression_graph`` (``nerf_rpn_tpu/ops/nms_graph.py:104-151``),
batched over problems.  For problem p with score-sorted boxes (Np, 6), Np a
multiple of 32, bit c of word w in row j is set iff ``32w + c < j`` and
``IoU(j, 32w + c) > iou_threshold`` (strict; the threshold compared as f32).

PyTorch's ``uint32`` has thin CUDA op coverage, so the words are ``int32``
holding the same bits.  ``aabb_suppression_graph`` launches the CUDA kernel
(``csrc/nms_graph.cu``) on CUDA tensors and runs the plain twin
``aabb_suppression_graph_reference`` on CPU tensors.

``resolve_keep`` takes greedy NMS's keep-set from the graph: the fixpoint
of ``alive <- valid & ~any(graph & packed(alive))`` that the JAX package
iterates in a ``while_loop`` (``nerf_rpn_tpu/ops/nms.py:258-270``).  On CUDA
tensors it launches the resolve kernel of ``csrc/nms_graph.cu`` (one pass
over the word columns in order, no host sync); on CPU tensors it runs the
sweep loop ``resolve_keep_reference``.
"""

from __future__ import annotations

import torch

from nerf_rpn_tpu_torch import kernels

WORD = 32
RESOLVE_MULTIPLE = 128  # 16-byte rows of the graph for the resolve kernel


def pack_bits(b: torch.Tensor) -> torch.Tensor:
    """bool (..., W*32) -> int32 (..., W); bit c of word w = element 32w+c.

    The words are summed in int64 and mapped to int32 with the same bits,
    so bit 31 cannot overflow."""
    powers = torch.ones((), dtype=torch.int64, device=b.device) << torch.arange(
        WORD, dtype=torch.int64, device=b.device)
    words = (b.reshape(*b.shape[:-1], -1, WORD).to(torch.int64) * powers).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def _check(boxes: torch.Tensor) -> tuple[int, int]:
    if boxes.dim() != 3 or boxes.shape[-1] != 6 or boxes.shape[1] % WORD:
        raise ValueError(
            f"boxes must be (P, Np, 6) with Np a multiple of {WORD}, "
            f"got {tuple(boxes.shape)}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    return boxes.shape[0], boxes.shape[1]


def aabb_suppression_graph_reference(boxes: torch.Tensor,
                                     iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch twin: (P, Np, 6) f32 -> int32 (P, Np, Np/32), computed
    in the kernel's order (inter = (ex*ey)*ez, union = (va + vb) - inter)."""
    _, np_ = _check(boxes)
    lo = torch.maximum(boxes[:, :, None, 0:3], boxes[:, None, :, 0:3])
    hi = torch.minimum(boxes[:, :, None, 3:6], boxes[:, None, :, 3:6])
    ext = (hi - lo).clamp_min(0.0)
    inter = ext[..., 0] * ext[..., 1] * ext[..., 2]
    side = (boxes[..., 3:6] - boxes[..., 0:3]).clamp_min(0.0)
    vol = side[..., 0] * side[..., 1] * side[..., 2]
    union = vol[:, :, None] + vol[:, None, :] - inter
    iou = torch.where(union > 0.0, inter / union.clamp_min(1e-30),
                      torch.zeros((), dtype=inter.dtype, device=inter.device))
    pos = torch.arange(np_, device=boxes.device)
    ov = (iou > iou_threshold) & (pos[None, :] < pos[:, None])
    return pack_bits(ov)


def aabb_suppression_graph(boxes: torch.Tensor,
                           iou_threshold: float) -> torch.Tensor:
    """(P, Np, 6) f32 score-sorted boxes -> int32 (P, Np, Np/32) graph.

    CPU tensors take the plain twin; CUDA tensors launch kernel K3 or raise.
    """
    if boxes.device.type == "cpu":
        return aabb_suppression_graph_reference(boxes, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    p, np_ = _check(boxes)
    boxes = boxes.contiguous()
    out = torch.empty((p, np_, np_ // WORD), dtype=torch.int32,
                      device=boxes.device)
    kernels.launch(
        "aabb_suppression_graph", boxes.data_ptr(), out.data_ptr(), p, np_,
        float(iou_threshold),
        torch.cuda.current_stream(boxes.device).cuda_stream)
    return out


def resolve_sweep(graph: torch.Tensor, svalid: torch.Tensor,
                  alive: torch.Tensor) -> torch.Tensor:
    """One sweep of the fixpoint: ``svalid & ~any(graph & packed(alive))``."""
    bits = pack_bits(alive)                                # (P, Np/32)
    sup = ((graph & bits[:, None, :]) != 0).any(dim=-1)    # (P, Np)
    return svalid & ~sup


def resolve_fixpoint(graph: torch.Tensor,
                     svalid: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The sweep loop to its fixpoint: ``(alive, sweeps)``, ``sweeps`` the
    number of sweeps it ran, the last one (which changed nothing) included.

    Every sweep fixes at least the next box of the greedy order, so Np + 1
    sweeps always suffice; each sweep but the first ends in a host sync
    (``torch.equal``).
    """
    alive = resolve_sweep(graph, svalid, svalid)
    for sweeps in range(2, graph.shape[1] + 2):
        nxt = resolve_sweep(graph, svalid, alive)
        if torch.equal(nxt, alive):
            break
        alive = nxt
    return alive, sweeps


def resolve_keep_reference(graph: torch.Tensor, svalid: torch.Tensor) -> torch.Tensor:
    """Plain twin of the resolve kernel: the sweep loop's fixpoint."""
    return resolve_fixpoint(graph, svalid)[0]


def resolve_keep(graph: torch.Tensor, svalid: torch.Tensor) -> torch.Tensor:
    """Greedy NMS keep-set in the sorted order: int32 (P, Np, Np/32) graph
    and (P, Np) bool validity -> (P, Np) bool.  The kernel reads a row's
    words 16 bytes at a time, so on CUDA tensors Np is a multiple of
    ``RESOLVE_MULTIPLE`` (``nms_mask`` pads to 256) and the graph 16-byte
    aligned.

    CPU tensors take the sweep twin; CUDA tensors launch the resolve kernel
    or raise.
    """
    if graph.device.type == "cpu":
        return resolve_keep_reference(graph, svalid)
    if graph.device.type != "cuda":
        raise ValueError(f"unsupported device {graph.device}")
    if (graph.dim() != 3 or graph.shape[1] % RESOLVE_MULTIPLE
            or graph.shape[2] != graph.shape[1] // WORD):
        raise ValueError(f"graph must be (P, Np, Np/{WORD}) with Np a multiple of "
                         f"{RESOLVE_MULTIPLE}, got {tuple(graph.shape)}")
    if graph.dtype != torch.int32 or svalid.dtype != torch.bool:
        raise TypeError(f"graph must be int32 and svalid bool, got {graph.dtype}, "
                        f"{svalid.dtype}")
    p, np_ = graph.shape[:2]
    if svalid.shape != (p, np_) or svalid.device != graph.device:
        raise ValueError(f"svalid must be ({p}, {np_}) on {graph.device}, got "
                         f"{tuple(svalid.shape)} on {svalid.device}")
    graph, svalid = graph.contiguous(), svalid.contiguous()
    if graph.data_ptr() % 16:
        raise ValueError("graph must be 16-byte aligned")
    alive = torch.empty((p, np_), dtype=torch.bool, device=graph.device)
    kernels.launch(
        "nms_resolve", graph.data_ptr(), svalid.data_ptr(), alive.data_ptr(), p, np_,
        torch.cuda.current_stream(graph.device).cuda_stream)
    return alive
