"""Layer applications with flax's dtype semantics, on channels-last tensors.

The modules keep their parameters in f32 (flax's ``param_dtype``) and cast
them to the compute dtype at use, as ``nn.Dense(dtype=...)`` and
``nn.Conv(dtype=...)`` do; LayerNorm computes in f32 and rounds its output
to the compute dtype, as flax's ``nn.LayerNorm(dtype=...)`` does.
Activations are channels-last ``(B, X, Y, Z, C)`` like the JAX package; a
convolution sees them as a channels-first view (the ``channels_last_3d``
memory format), so no copy is made around it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    bias = lin.bias.to(dtype) if lin.bias is not None else None
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
    return y.to(dtype)


def conv3d(x: torch.Tensor, conv: nn.Conv3d, dtype: torch.dtype) -> torch.Tensor:
    """Channels-last (B, X, Y, Z, C) in and out."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).to(dtype), conv.weight.to(dtype),
                 conv.bias.to(dtype) if conv.bias is not None else None,
                 conv.stride, conv.padding)
    return y.permute(0, 2, 3, 4, 1)


def group_norm(x: torch.Tensor, gn: nn.GroupNorm, dtype: torch.dtype) -> torch.Tensor:
    """Channels-last (B, X, Y, Z, C) in and out; statistics and affine in
    f32, the output rounded to the compute dtype."""
    y = F.group_norm(x.permute(0, 4, 1, 2, 3).float(), gn.num_groups, gn.weight, gn.bias,
                     gn.eps)
    return y.permute(0, 2, 3, 4, 1).to(dtype)
