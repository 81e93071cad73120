"""3D max pools of the CNN backbones (port of ``nerf_rpn_tpu/ops/pooling.py``).

Channels-last ``(B, X, Y, Z, C)`` in and out; each pool is one
``F.max_pool3d`` on the channels-first view, with no copy around it.  The
JAX module's pair-regrouped forms and its ``NERF_RPN_TPU_POOL_RW`` /
``NERF_RPN_TPU_POOL2_REGROUP`` knobs exist for the TPU compiler; a max is
exact, so the plain pools equal them bit for bit in every dtype.

Under ``torch.use_deterministic_algorithms(True)`` a pool that needs a
gradient on the card routes its backward through ``index_put_`` with
``accumulate=True``, which has a deterministic form; ``F.max_pool3d``'s own
CUDA backward adds with atomics and has none.

On the ``space`` axis (``parallel/space.py``) :func:`max_pool_slab` fetches
the x rows of its output slab's windows: -inf beyond the global edges only
(the pad of the stem pool, the high side of a ceil-mode window), the
neighbours' real rows everywhere else.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nerf_rpn_tpu_torch.parallel import space


class _MaxPool3dIndexPut(torch.autograd.Function):
    """``F.max_pool3d`` whose backward adds each output's gradient into the
    input it took with one ``index_put_(accumulate=True)``."""

    @staticmethod
    def forward(ctx, x, kernel, stride, padding, ceil_mode):
        y, idx = F.max_pool3d(x, kernel, stride, padding, ceil_mode=ceil_mode,
                              return_indices=True)
        ctx.save_for_backward(idx)
        ctx.in_shape = x.shape
        return y

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n, c, *spatial = ctx.in_shape
        planes = n * c
        # each (batch, channel) plane's indices point into its own X*Y*Z
        size = spatial[0] * spatial[1] * spatial[2]
        offsets = torch.arange(planes, device=g.device).mul_(size)[:, None]
        flat = (idx.reshape(planes, -1) + offsets).reshape(-1)
        gx = g.new_zeros(planes * size)
        gx.index_put_((flat,), g.reshape(-1), accumulate=True)
        return gx.view(ctx.in_shape), None, None, None, None


def _pool(x: torch.Tensor, kernel: int, stride: int, padding,
          ceil_mode: bool) -> torch.Tensor:
    x = x.permute(0, 4, 1, 2, 3)
    if x.is_cuda and x.requires_grad and torch.are_deterministic_algorithms_enabled():
        y = _MaxPool3dIndexPut.apply(x, kernel, stride, padding, ceil_mode)
    else:
        y = F.max_pool3d(x, kernel, stride, padding, ceil_mode=ceil_mode)
    return y.permute(0, 2, 3, 4, 1)


def max_pool_2x2x2(x: torch.Tensor, ceil_mode: bool = True) -> torch.Tensor:
    """2^3 stride-2 max pool.  An odd extent gives ``L // 2 + 1`` outputs
    with ``ceil_mode`` (the last window reads one row and the -inf pad of
    JAX's form), ``L // 2`` without."""
    return _pool(x, 2, 2, 0, ceil_mode)


def max_pool_3x3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    """The ResNet/VGG stem pool: 3^3, stride 2, padding 1 (padded with
    -inf), output extent ``(L - 1) // 2 + 1``."""
    return _pool(x, 3, 2, 1, False)


stem_pool = max_pool_3x3x3_s2_p1


def max_pool_slab(x: torch.Tensor, src: "space.Slab", dst: "space.Slab", kernel: int,
                  stride: int, padding: int, ceil_mode: bool = False) -> torch.Tensor:
    """A ``kernel``^3 max pool of stride ``stride`` and -inf ``padding`` from
    the input slabs ``src`` into the output slabs ``dst`` (of the pool's
    global output extent: with ``ceil_mode`` the ceil-divided one, whose
    last window reads x rows past the global edge, fetched as -inf).  y and
    z keep ``ceil_mode`` as :func:`max_pool_2x2x2` does.  Every rank of the
    space group calls it."""
    x = space.reshard_x(x, src, space.window_rows(src, dst, kernel, stride, padding),
                        fill=float("-inf"))
    if dst.rows == 0:
        yz = [_pooled(n, kernel, stride, padding, ceil_mode) for n in x.shape[2:4]]
        return space.keep_graph_empty((x.shape[0], 0, *yz, x.shape[-1]), x)
    return _pool(x, kernel, stride, (0, padding, padding), ceil_mode)


def _pooled(n: int, kernel: int, stride: int, padding: int, ceil_mode: bool) -> int:
    """The output extent of a pool over ``n`` (``F.max_pool3d``'s rule: a
    ceil-mode window starts inside the input or its left padding)."""
    span = n + 2 * padding - kernel
    out = (-(-span // stride) if ceil_mode else span // stride) + 1
    if ceil_mode and (out - 1) * stride >= n + padding:
        out -= 1
    return out
