"""Detection heads (port of ``nerf_rpn_tpu/models/heads.py``): the anchor
RPN head and the anchor-free FCOS head.

``RPNHead3D`` (``heads.py:164-213``): a tower of ``conv_depth`` x (3^3
conv + ReLU) shared over levels, then one 1x1 product whose kernel is the
cls and bbox kernels concatenated; logits are ``[..., :A]`` and deltas
``[..., A:]`` (anchor-major, 6 per anchor, or 8 with ``rotate``: the
midpoint-offset deltas of an OBB).
Parameter names follow the reference torch keys ``conv.{2d}``,
``cls_logits`` and ``bbox_pred``; output channels stay in the JAX
package's anchor order.

``FCOSHead3D`` (``heads.py:216-344``): twin towers of ``num_convs`` x
(3^3 conv + GroupNorm(32) + ReLU) shared over levels, then 3^3 convs to 1
class logit, the 6 distances (8 with ``rotate``: + the 2 midpoint offsets
of an OBB) and 1 centerness logit, the centerness on the box tower with
``centerness_on_reg``; a learned scalar ``Scale`` per level multiplies the
box output.  With ``norm_reg_targets`` the distances pass a ReLU and, in
eval only, are multiplied by the level's stride, and channels 6:8 pass
through the ``Scale`` alone; without it every channel takes ``exp``.  The
parameter names are the reference torch keys: ``cls_tower.{3d}`` (conv),
``cls_tower.{3d+1}`` (GroupNorm), the same for ``bbox_tower``,
``cls_logits``, ``bbox_pred``, ``centerness`` and ``scales.{lvl}.scale``.
The JAX head's ``GroupNormFast`` and batch-folded tower are TPU forms of
plain ``nn.GroupNorm`` and are not ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nerf_rpn_tpu_torch.models.layers import conv3d, group_norm


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


class Scale(nn.Module):
    """A learned scalar multiplier, one per FPN level."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor([init_value]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


class FCOSHead3D(nn.Module):
    def __init__(self, in_channels: int = 256, num_levels: int = 4, num_convs: int = 4,
                 rotate: bool = False, centerness_on_reg: bool = True,
                 norm_reg_targets: bool = True,
                 fpn_strides: Sequence[int] = (4, 8, 16, 32),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.centerness_on_reg = centerness_on_reg
        self.norm_reg_targets = norm_reg_targets
        self.fpn_strides = tuple(fpn_strides)
        reg_ch = 8 if rotate else 6
        for name in ("cls_tower", "bbox_tower"):
            tower = []
            for _ in range(num_convs):
                tower += [nn.Conv3d(in_channels, in_channels, 3, padding=1),
                          nn.GroupNorm(32, in_channels, eps=1e-5), nn.ReLU()]
            setattr(self, name, nn.Sequential(*tower))
        self.cls_logits = nn.Conv3d(in_channels, 1, 3, padding=1)
        self.bbox_pred = nn.Conv3d(in_channels, reg_ch, 3, padding=1)
        self.centerness = nn.Conv3d(in_channels, 1, 3, padding=1)
        self.scales = nn.ModuleList([Scale(1.0) for _ in range(num_levels)])

    def _tower(self, x: torch.Tensor, tower: nn.Sequential) -> torch.Tensor:
        for conv, gn in zip(tower[0::3], tower[1::3]):
            x = torch.relu(group_norm(conv3d(x, conv, self.dtype), gn, self.dtype))
        return x

    def _predict(self, x: torch.Tensor, convs: Sequence[nn.Conv3d]) -> torch.Tensor:
        """The 3^3 prediction convs that read one tower output, as one conv
        of their concatenated kernels."""
        w = torch.cat([c.weight for c in convs]).to(self.dtype)
        b = torch.cat([c.bias for c in convs]).to(self.dtype)
        y = torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3), w, b, padding=1)
        return y.permute(0, 2, 3, 4, 1)

    def forward(self, features: Sequence[torch.Tensor]):
        """Per level (B, X, Y, Z, C) -> (cls, reg, ctr) lists of (B, X, Y,
        Z, 1), (B, X, Y, Z, 6|8) and (B, X, Y, Z, 1).  ``reg`` is f32 (the
        f32 ``Scale`` promotes it, as in the JAX head)."""
        cls_out, reg_out, ctr_out = [], [], []
        for lvl, f in enumerate(features):
            ct = self._tower(f, self.cls_tower)
            bt = self._tower(f, self.bbox_tower)
            if self.centerness_on_reg:
                cls_out.append(self._predict(ct, [self.cls_logits]))
                merged = self._predict(bt, [self.centerness, self.bbox_pred])
                ctr_out.append(merged[..., :1])
                reg = merged[..., 1:]
            else:
                merged = self._predict(ct, [self.cls_logits, self.centerness])
                cls_out.append(merged[..., :1])
                ctr_out.append(merged[..., 1:2])
                reg = self._predict(bt, [self.bbox_pred])
            reg = self.scales[lvl](reg)
            if self.norm_reg_targets:
                dist = torch.relu(reg[..., :6])
                if not self.training:
                    dist = dist * self.fpn_strides[lvl]
                reg = torch.cat([dist, reg[..., 6:]], dim=-1)
            else:
                reg = torch.exp(reg)
            reg_out.append(reg)
        return cls_out, reg_out, ctr_out
