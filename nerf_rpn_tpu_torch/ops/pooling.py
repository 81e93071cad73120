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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def _pool(x: torch.Tensor, kernel: int, stride: int, padding: int,
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
