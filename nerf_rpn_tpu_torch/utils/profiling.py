"""Profiling / tracing helpers (the torch port of
``nerf_rpn_tpu/utils/profiling.py``).

- ``trace(logdir)``: ``torch.profiler`` over CPU and, where there is a GPU,
  CUDA activity; writes a Chrome / TensorBoard trace
  (``<worker>.<time>.pt.trace.json``) into ``logdir`` on exit.
- ``benchmark_fn``: the chained-step latency harness of the JAX package:
  ``fn(*args, carry) -> scalar carry``, one device synchronisation after the
  warm-up and one after the timed calls.
- ``nan_check``: a wrapper that raises on NaN/Inf in any floating tensor
  of ``fn``'s output tree, naming the leaf's path (the JAX package's
  ``checkify`` float checks read every intermediate; this reads outputs).
- ``device_busy`` / ``span_union_us``: the device-busy time of one call,
  the union of the device spans that ``torch.profiler`` records, which
  ``chip_smoke.py`` and ``cli/profile_eval.py`` read.
"""

from __future__ import annotations

import contextlib
import time

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; on exit write its trace into ``logdir``."""
    handler = torch.profiler.tensorboard_trace_handler(logdir)
    with torch.profiler.profile(activities=_activities(), on_trace_ready=handler) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _leaves(tree, path=""):
    """(path, leaf) of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_fn(fn, *args, warmup: int = 3, reps: int = 30):
    """Mean seconds/call for ``fn(*args, carry) -> scalar carry``.

    ``fn`` must thread the scalar float32 carry so each call data-depends
    on the previous one.  The carry starts at 0 on the device of the first
    tensor in ``args`` (the CPU if there is none).
    """
    tensors = [leaf for _, leaf in _leaves(args) if isinstance(leaf, torch.Tensor)]
    device = tensors[0].device if tensors else torch.device("cpu")
    carry = torch.zeros((), dtype=torch.float32, device=device)
    for _ in range(warmup):
        carry = fn(*args, carry)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        carry = fn(*args, carry)
    _sync(device)
    return (time.perf_counter() - t0) / reps


def nan_check(fn):
    """Wrap ``fn`` so that NaN/Inf in any floating tensor of its output
    raises ``FloatingPointError`` naming the leaf's path."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for path, leaf in _leaves(out):
            if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                    and not bool(torch.isfinite(leaf).all())):
                raise FloatingPointError(
                    f"nan_check: non-finite values in output{path} of "
                    f"{getattr(fn, '__name__', fn)!s}")
        return out

    return wrapper


def span_union_us(spans) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_busy(fn) -> tuple[float, int]:
    """``(device-busy ms, kernels)`` of one call of ``fn``: the union of
    the device spans that ``torch.profiler`` records."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=_activities()) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return span_union_us(spans) / 1e3, len(spans)
