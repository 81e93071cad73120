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
rows once each (``ddp.batch_moments``); GroupNorm sums each scene's
moments over the space group (:func:`group_norm`).
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
    return conv3d_kernel(x, conv.weight, conv.bias, conv.stride, conv.padding, dtype, src, dst)


def conv3d_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                  stride, padding, dtype: torch.dtype, src: "space.Slab | None" = None,
                  dst: "space.Slab | None" = None) -> torch.Tensor:
    """:func:`conv3d` of a (Cout, Cin, k, k, k) ``weight`` and ``bias`` (the
    FCOS head's concatenated prediction kernels)."""
    bias = bias.to(dtype) if bias is not None else None
    if src is None:
        y = F.conv3d(x.permute(0, 4, 1, 2, 3).to(dtype), weight.to(dtype), bias, stride,
                     padding)
        return y.permute(0, 2, 3, 4, 1)
    dst = dst or src
    k, s, p = weight.shape[2], stride[0], padding[0]
    if not (k == 1 and s == 1 and src.bounds == dst.bounds):
        x = space.reshard_x(x, src, space.window_rows(src, dst, k, s, p))
    if dst.rows == 0:
        shape = (x.shape[0], 0, *(-(-(n + 2 * q - kk + 1) // st) for n, q, kk, st in zip(
            x.shape[2:4], padding[1:], weight.shape[3:], stride[1:])), weight.shape[0])
        return space.keep_graph_empty(shape, x.to(dtype), weight, bias)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).to(dtype), weight.to(dtype), bias, stride,
                 (0, *padding[1:]))
    return y.permute(0, 2, 3, 4, 1)


def group_norm(x: torch.Tensor, gn: nn.GroupNorm, dtype: torch.dtype,
               slab: "space.Slab | None" = None) -> torch.Tensor:
    """Channels-last (B, X, Y, Z, C) in and out, with the JAX head's
    ``GroupNormFast`` arithmetic (``nerf_rpn_tpu/models/heads.py``): the
    moments of each (scene, group) in f32 (f64 for f64 input) in one pass,
    ``var = max(E[x^2] - E[x]^2, 0)``, folded into ``a = weight /
    sqrt(var + eps)`` and ``b = bias - mean * a``, and the output ``x * a +
    b`` in ``x``'s dtype (one ``addcmul``: the product and the sum rounded
    once, as XLA fuses them), rounded to the compute dtype.  A group of one
    value (``resnet_tiny``'s 32 channels in 32 groups at a 1^3 level) has
    variance 0 and normalises to the bias up to the rounding of ``x * a``,
    as in JAX.

    ``slab``: ``x``'s slabs on the space axis.  The sums ``sum x`` and
    ``sum x^2`` of the rank's rows are then summed over the space group
    (``space.all_reduce_sum``; a slab with no rows adds zeros) and divided
    by the whole extent's count, so each scene is normalised by the
    statistics of all of its rows; one formula for the whole grid and the
    slab."""
    b, c, g = x.shape[0], x.shape[-1], gn.num_groups
    ft = torch.promote_types(x.dtype, torch.float32)
    rows = x.shape[1] * x.shape[2] * x.shape[3]
    xf = x.reshape(b, rows, c).to(ft)
    # per channel over the rows (a reduction along contiguous channels),
    # then over each group's channels: (B, 2, G)
    sums = torch.stack([xf.sum(1), (xf * xf).sum(1)], 1).view(b, 2, g, c // g).sum(-1)
    count = rows * (c // g)
    if slab is not None:
        sums = space.all_reduce_sum(sums, slab.groups)
        count = slab.extent * x.shape[2] * x.shape[3] * (c // g)
    mean, mean2 = sums[:, 0] / count, sums[:, 1] / count
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    a = torch.rsqrt(var + gn.eps)[..., None] * gn.weight.to(ft).view(g, c // g)
    shift = gn.bias.to(ft).view(g, c // g) - mean[..., None] * a
    shape = (b, 1, 1, 1, c)
    y = torch.addcmul(shift.reshape(shape).to(x.dtype), x, a.reshape(shape).to(x.dtype))
    return y.to(dtype)


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
