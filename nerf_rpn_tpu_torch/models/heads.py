"""Anchor RPN head (port of ``RPNHead3D``, ``nerf_rpn_tpu/models/heads.py:164-213``).

A tower of ``conv_depth`` x (3^3 conv + ReLU) shared over levels, then one
1x1 product whose kernel is the cls and bbox kernels concatenated; logits
are ``[..., :A]`` and deltas ``[..., A:]`` (anchor-major, 6 per anchor,
or 8 with ``rotate``: the midpoint-offset deltas of an OBB).
Parameter names follow the reference torch keys ``conv.{2d}``,
``cls_logits`` and ``bbox_pred``; output channels stay in the JAX
package's anchor order.  The FCOS head is not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nerf_rpn_tpu_torch.models.layers import conv3d


class RPNHead3D(nn.Module):
    def __init__(self, in_channels: int = 256, num_anchors: int = 13,
                 conv_depth: int = 2, rotate: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_anchors = num_anchors
        self.reg_ch = 8 if rotate else 6
        tower = []
        for _ in range(conv_depth):
            tower += [nn.Conv3d(in_channels, in_channels, 3, padding=1), nn.ReLU()]
        self.conv = nn.Sequential(*tower)
        self.cls_logits = nn.Conv3d(in_channels, num_anchors, 1)
        self.bbox_pred = nn.Conv3d(in_channels, num_anchors * self.reg_ch, 1)

    def forward(self, features: Sequence[torch.Tensor]):
        """Per level (B, X, Y, Z, C) -> (logits, deltas) lists of
        (B, X, Y, Z, A) and (B, X, Y, Z, A * reg_ch)."""
        a = self.num_anchors
        weight = torch.cat([self.cls_logits.weight, self.bbox_pred.weight], 0)
        weight = weight.reshape(weight.shape[0], -1).to(self.dtype)
        bias = torch.cat([self.cls_logits.bias, self.bbox_pred.bias]).to(self.dtype)
        logits, deltas = [], []
        for t in features:
            for conv in self.conv[::2]:
                t = torch.relu(conv3d(t, conv, self.dtype))
            y = F.linear(t, weight, bias)
            logits.append(y[..., :a])
            deltas.append(y[..., a:])
        return logits, deltas
