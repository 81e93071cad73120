"""Data-parallel training: one rank (process) a GPU.

Counterpart of the ``data`` axis of ``nerf_rpn_tpu/parallel/mesh.py``
(``make_mesh``, ``process_barrier``, ``shard_batch``) and of the reference's
DDP (``mp.spawn``, NCCL, ``DistributedSampler``; SURVEY 2.11).  The JAX
step is one ``jit`` over the whole batch, so each of its sums runs over
every scene.  The port keeps those global-batch semantics with world N
ranks of B / N scenes each:

- a rank divides its own loss numerators by the *global* normalisers, the
  counts summed over the ranks by :func:`all_reduce_sum` and clamped after
  the sum, as JAX clamps;
- the gradients are summed over the ranks (:func:`all_reduce_grads_`), not
  averaged, before the clip, so every rank takes the step that one process
  takes on the whole batch;
- train-mode BatchNorm takes its moments over every rank's scenes
  (:func:`batch_moments`, through :class:`AllReduceSum`, whose backward is
  the same sum).

The model is not wrapped in ``nn.parallel.DistributedDataParallel``: the
RCNN step calls submodules outside ``forward``, where DDP's reducer is never
prepared, and one coalesced all-reduce after the backward serves the three
steps alike.  Every helper is a no-op without a process group or at world
1, so a one-process run computes what it computed without this module.

Process groups (:func:`run_driver`): ``--gpus 0-3`` (or ``0,1,2,3``)
starts one rank a listed GPU with ``torch.multiprocessing.spawn`` (one
listed GPU: this process, in a group of one), NCCL with a TCP rendezvous on
127.0.0.1 at a free port; a process started with torchrun's environment
(``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) joins that group instead, over gloo with ``--device cpu``.
Only ``--mode train`` is data parallel: ``eval`` and ``benchmark`` run on
the first listed GPU, as the JAX drivers evaluate at their batch of 1 on a
one-device mesh (``make_mesh_for_batch``).
"""

from __future__ import annotations

import datetime
import math
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from nerf_rpn_tpu_torch.device import resolve_device

# the other ranks wait at the epoch-end barrier while rank 0 evaluates and
# writes checkpoints alone: NCCL's default of 10 minutes is too short there
TIMEOUT = datetime.timedelta(hours=1)


def parse_gpus(spec: str) -> list[int]:
    """The reference's ``--gpus``: ``"0-3"``, ``"0,1,2,3"`` (or a mix,
    ``"0-1,3"``) -> ``[0, 1, 2, 3]``; ``""`` -> ``[]``."""
    gpus = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        lo, dash, hi = part.partition("-")
        if not lo.isdigit() or (dash and not hi.isdigit()) or (dash and int(hi) < int(lo)):
            raise ValueError(f"--gpus {spec!r}: expected GPU indices such as 0-3 or 0,1,2,3")
        gpus.extend(range(int(lo), int(hi if dash else lo) + 1))
    if len(set(gpus)) != len(gpus):
        raise ValueError(f"--gpus {spec!r} lists a GPU twice")
    return gpus


def world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    """Every rank waits for the others (``process_barrier``, ``mesh.py:40-65``):
    at the epoch end, where rank 0 has evaluated and written checkpoints
    alone."""
    if world() > 1:
        dist.barrier()


def seed_for_rank(seed: int) -> int:
    """Rank r's seed for its sampling and drop-path generators: rank 0 keeps
    ``seed``'s streams, the other ranks draw streams of their own."""
    return seed + 1_000_003 * rank()


def all_reduce_sum(*tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The sums over the ranks of detached tensors (counts, loss terms,
    metrics), in one collective; each keeps its shape and dtype (the sum
    runs in f64, exact for counts).  At world 1 the tensors come back as
    given."""
    if world() == 1:
        return tensors
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
    dist.all_reduce(flat)
    out = flat.split([t.numel() for t in tensors])
    return tuple(o.reshape(t.shape).to(t.dtype) for o, t in zip(out, tensors))


def all_reduce_max(values: np.ndarray) -> np.ndarray:
    """The elementwise maximum over the ranks of a host integer array (the
    RCNN batch's padded shapes)."""
    if world() == 1:
        return values
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.as_tensor(values, dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.cpu().numpy().astype(values.dtype)


class AllReduceSum(torch.autograd.Function):
    """``all_reduce(SUM)`` with autograd.  Every rank's loss reads the summed
    value, so the gradient of one rank's input is the sum over the ranks of
    the gradients of the output: the backward is the same all-reduce."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def batch_moments(x: torch.Tensor, dims: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """``(E[x], E[x^2])`` over ``dims`` of the global batch: the means of
    ``x`` at world 1; else sum(x), sum(x^2) and the count, summed over the
    ranks through :class:`AllReduceSum`, then divided."""
    if world() == 1:
        return x.mean(dims), (x * x).mean(dims)
    c = x.shape[-1]
    count = x.new_full((1,), math.prod(x.shape[d] for d in dims))
    sums = AllReduceSum.apply(torch.cat([x.sum(dims), (x * x).sum(dims), count]))
    return sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]


def _coalesced(tensors, collective) -> None:
    """``collective(flat)`` on one flat buffer a dtype, copied back in place
    (the same order on every rank: dtypes by first appearance)."""
    groups: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for group in groups.values():
        flat = _flatten_dense_tensors(group)
        collective(flat)
        for t, r in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(r)


@torch.no_grad()
def all_reduce_grads_(grads) -> None:
    """Sums the gradients over the ranks, in place."""
    if world() > 1:
        _coalesced(grads, dist.all_reduce)


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers (the BatchNorms' running statistics)
    to every rank, in place: at the start and after a checkpoint load."""
    if world() > 1:
        _coalesced([*module.parameters(), *module.buffers()],
                   lambda flat: dist.broadcast(flat, 0))


# ---------------------------------------------------------------------------
# Process groups
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_in_group(fn, fn_args, rank: int, world: int, device: torch.device, backend: str,
                 init_method: str):
    """``fn(*fn_args)`` as rank ``rank`` of ``world`` on ``device`` (``cuda``
    alone: the current CUDA device); the group is destroyed after it,
    whatever it raised."""
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=TIMEOUT)
    try:
        return fn(*fn_args)
    finally:
        dist.destroy_process_group()


def _spawned(index, fn, fn_args, devices, backend, init_method):
    run_in_group(fn, fn_args, index, len(devices), devices[index], backend, init_method)


def launch(fn, fn_args, devices, backend: str, init_method: str | None = None):
    """``fn(*fn_args)`` on one rank a device of ``devices`` (rank r on
    ``devices[r]``), with ``backend`` (``"nccl"``, or ``"gloo"``, which also
    carries CUDA tensors for all-reduce and broadcast) and a TCP rendezvous
    at a free port unless ``init_method`` says otherwise.  One device: in
    this process, returning ``fn``'s result; more: spawned processes, which
    leave their results where ``fn`` writes them, and None here.  A rank
    that raises makes this raise."""
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    if len(devices) == 1:
        return run_in_group(fn, fn_args, 0, 1, devices[0], backend, init_method)
    torch.multiprocessing.spawn(_spawned, args=(fn, fn_args, devices, backend, init_method),
                                nprocs=len(devices), join=True)
    return None


def _driver_rank(fn, args, devices):
    args.device = str(devices[rank()])
    return fn(args)


def run_driver(fn, args):
    """A driver's ``fn(args)`` on the ranks that ``args`` asks for.

    ``--gpus`` names CUDA devices: it raises beside ``--device cpu`` (or
    another device), and through ``resolve_device`` where CUDA or a listed
    index is missing.  ``--mode train`` with ``--gpus`` runs one rank a
    listed GPU (NCCL); in torchrun's environment it joins that group, on
    ``cuda:<gpus[LOCAL_RANK]>`` (``cuda:<LOCAL_RANK>`` without ``--gpus``)
    or, with ``--device cpu``, on the CPU over gloo.  Other modes run in
    this process, on the first listed GPU.  Returns ``fn``'s result, or
    None where spawned ranks ran it."""
    gpus = parse_gpus(args.gpus)
    if gpus and args.device != "cuda":
        raise ValueError(f"--gpus names CUDA devices; it cannot go with --device {args.device}")
    devices = [resolve_device(f"cuda:{g}") for g in gpus]
    if args.mode == "train" and "WORLD_SIZE" in os.environ:
        rank_, world_ = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank_))
        if args.device == "cpu":
            device = torch.device("cpu")
        else:
            device = devices[local] if devices else resolve_device(f"cuda:{local}")
        args.device = str(device)
        return run_in_group(fn, (args,), rank_, world_, device,
                            "gloo" if device.type == "cpu" else "nccl", "env://")
    if not devices:
        return fn(args)
    if args.mode != "train":
        args.device = str(devices[0])
        return fn(args)
    return launch(_driver_rank, (fn, args, devices), devices, "nccl")
