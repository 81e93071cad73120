"""Layer applications with flax's dtype semantics, on channels-last tensors.

The modules keep their parameters in f32 (flax's ``param_dtype``) and cast
them to the compute dtype at use, as ``nn.Dense(dtype=...)`` and
``nn.Conv(dtype=...)`` do; LayerNorm computes in f32 (f64 for f64 input)
and rounds its output to the compute dtype, as flax's ``nn.LayerNorm(dtype=...)`` does, and
BatchNorm follows flax's ``nn.BatchNorm`` (:func:`batch_norm`).
Activations are channels-last ``(B, X, Y, Z, C)`` like the JAX package; a
convolution sees them as a channels-first view (the ``channels_last_3d``
memory format), so no copy is made around it.

On the ``space`` axis (``parallel/space.py``) a convolution takes a slab:
:func:`conv3d` given its slabs fetches the x rows its output slab reads (a halo of
``k // 2`` rows for a stride-1 3^3 conv, zero beyond the global edges; a
strided conv's rows from the output slab's global origin) and runs with no
x padding.  Train-mode BatchNorm sums its moments over every rank, slab
rows once each (``ddp.batch_moments``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from nerf_rpn_tpu_torch.parallel import ddp, space


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    bias = lin.bias.to(dtype) if lin.bias is not None else None
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    y = F.layer_norm(x.to(torch.promote_types(x.dtype, torch.float32)), ln.normalized_shape,
                     ln.weight, ln.bias, ln.eps)
    return y.to(dtype)


def conv3d(x: torch.Tensor, conv: nn.Conv3d, dtype: torch.dtype,
           src: "space.Slab | None" = None, dst: "space.Slab | None" = None) -> torch.Tensor:
    """Channels-last (B, X, Y, Z, C) in and out.  On the space axis: from
    the input slabs ``src`` into the output slabs ``dst`` (default
    ``src``; the conv's global x extent ``dst.extent``); every rank of the
    space group calls it."""
    if src is None:
        y = F.conv3d(x.permute(0, 4, 1, 2, 3).to(dtype), conv.weight.to(dtype),
                     conv.bias.to(dtype) if conv.bias is not None else None,
                     conv.stride, conv.padding)
        return y.permute(0, 2, 3, 4, 1)
    return _conv3d_slab(x, conv, dtype, src, dst or src)


def _conv3d_slab(x: torch.Tensor, conv: nn.Conv3d, dtype: torch.dtype,
                 src: "space.Slab", dst: "space.Slab") -> torch.Tensor:
    k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    if not (k == 1 and s == 1 and src.bounds == dst.bounds):
        x = space.reshard_x(x, src, space.window_rows(src, dst, k, s, p))
    if dst.rows == 0:
        shape = (x.shape[0], 0, *(-(-(n + 2 * q - kk + 1) // st) for n, q, kk, st in zip(
            x.shape[2:4], conv.padding[1:], conv.kernel_size[1:], conv.stride[1:])),
            conv.out_channels)
        return space.keep_graph_empty(shape, x.to(dtype), conv.weight, conv.bias)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).to(dtype), conv.weight.to(dtype),
                 conv.bias.to(dtype) if conv.bias is not None else None,
                 conv.stride, (0, *conv.padding[1:]))
    return y.permute(0, 2, 3, 4, 1)


def group_norm(x: torch.Tensor, gn: nn.GroupNorm, dtype: torch.dtype) -> torch.Tensor:
    """Channels-last (B, X, Y, Z, C) in and out; statistics and affine in
    f32 (f64 for f64 input), the output rounded to the compute dtype.  A
    group of one value (``resnet_tiny``'s 32 channels in 32 groups at a 1^3
    level) normalises to the bias, as in JAX: the aten op is called
    directly, without ``F.group_norm``'s refusal of such groups."""
    xf = x.permute(0, 4, 1, 2, 3).to(torch.promote_types(x.dtype, torch.float32))
    y = torch.group_norm(xf, gn.num_groups, gn.weight, gn.bias, gn.eps)
    return y.permute(0, 2, 3, 4, 1).to(dtype)


def bn3d(channels: int) -> nn.BatchNorm3d:
    """A holder of a BatchNorm's parameters and running statistics (the
    reference keys); the arithmetic is :func:`batch_norm`'s (flax's
    momentum 0.9 is torch's 0.1)."""
    return nn.BatchNorm3d(channels, eps=1e-5, momentum=0.1)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm3d, dtype: torch.dtype) -> torch.Tensor:
    """Channels-last (B, X, Y, Z, C) in and out, with flax's
    ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` arithmetic, not torch's.

    ``bn`` holds the parameters and running statistics (the reference
    state-dict keys).  In train mode (``bn.training``) the statistics are
    the batch's, in f32: ``mean = E[x]`` and the biased ``var = max(E[x^2]
    - E[x]^2, 0)``, and the running statistics move once a call to ``(1 -
    m) * running + m * batch`` with ``m = bn.momentum`` (0.1, flax's 0.9)
    -- with the biased variance, where torch's own BatchNorm takes the
    unbiased one.  Under a process group of more than one rank the batch is
    the global one: the moments are summed over the ranks
    (``parallel.ddp.batch_moments``), so the running statistics move alike
    on every rank.  Eval mode normalises with the running statistics and
    runs no collective (rank 0 evaluates alone).  The output is ``(x -
    mean) * (rsqrt(var + eps) * weight) + bias`` in f32 (f64 for f64
    input), rounded to the compute dtype.
    """
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if bn.training:
        dims = tuple(range(x.dim() - 1))
        mean, mean_sq = ddp.batch_moments(xf, dims)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.copy_(bn.running_mean * (1.0 - m) + mean.detach() * m)
            bn.running_var.copy_(bn.running_var * (1.0 - m) + var.detach() * m)
            bn.num_batches_tracked.add_(1)
    else:
        mean, var = bn.running_mean, bn.running_var
    y = (xf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
    return y.to(dtype)
