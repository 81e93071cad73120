"""3D ResNet-FPN backbones (port of ``nerf_rpn_tpu/models/resnet.py``).

Channels-last ``(B, X, Y, Z, C)`` activations like the JAX package; the
BatchNorms follow flax's arithmetic (``models/layers.batch_norm``) and
``self.training``: batch statistics and a running update in train mode,
the running statistics in eval mode.

- ``ResNetFPN256``: a 7^3 stride-2 stem (no bias), BN, ReLU and the 3^3
  stride-2 stem pool, bottleneck stages (expansion 4) of widths
  ``base_width * 2**i``, a built-in FPN (1x1 laterals, nearest top-down,
  3^3 smooths on all but the top level).  ``resnet`` is layers (3, 4, 6,
  3), base 64, 256 channels out; ``resnet_tiny`` (1, 1, 1, 1), 8, 32.
- ``ResNetFPN64``: a stride-1 stem of width 16, no pool, 64 channels out,
  a trilinear top-down path.
- ``ResNetSimplified``: the stem and basic residual blocks, one level.

Module names are the reference torch keys that
``nerf_rpn_tpu/tools/convert_weights.convert_resnet_fpn256`` reads:
``conv1``, ``bn1``, ``layers.{i}.{j}.conv{1,2,3}`` / ``.bn{1,2,3}`` /
``.downsample.{0,1}``, ``latlayers.{k}`` (level ``n-1-k``) and
``smooths.{i}`` (level ``n-2-i``).  ``flax_names`` maps each onto the JAX
module's name, for ``weights.py``.  The JAX stem's z-unfolded and s2d
forms (``StemConv3D``, ``NERF_RPN_TPU_STEM_S2D``) are the plain 7^3 conv in
a TPU layout and are not ported.

On the ``space`` axis (``parallel/space.py``) ``ResNetFPN.forward`` takes a
slab of the grid (``space=`` its input slabs) and gives each level on even
slabs of its global x extent (:meth:`ResNetFPN.level_slabs`): the stem,
the strided bottlenecks and the 3^3 convs fetch their input rows
(``layers.conv3d`` given slabs), the stem pool its -inf-padded ones
(``pooling.max_pool_slab``), and the top-down path reads its source rows by
global coordinate (:func:`upsample_nearest_slab`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nerf_rpn_tpu_torch.models.fpn import upsample_nearest, upsample_nearest_slab
from nerf_rpn_tpu_torch.models.layers import batch_norm, bn3d, conv3d
from nerf_rpn_tpu_torch.ops.pooling import max_pool_slab, stem_pool


def upsample_trilinear(x: torch.Tensor, target_shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(method="trilinear")`` of (B, X, Y, Z, C) to a
    larger (X', Y', Z'): half-pixel centres, the edge rows repeated, which
    is ``align_corners=False``."""
    y = F.interpolate(x.permute(0, 4, 1, 2, 3), size=tuple(target_shape), mode="trilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 4, 1)


class Bottleneck(nn.Module):
    """1^3 (stride s) -> 3^3 -> 1^3, expansion 4, BN after each; a 1^3
    conv + BN shortcut where the stride or the width changes."""

    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        out = planes * self.expansion
        self.conv1 = nn.Conv3d(in_channels, planes, 1, stride=stride, bias=False)
        self.bn1 = bn3d(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = bn3d(planes)
        self.conv3 = nn.Conv3d(planes, out, 1, bias=False)
        self.bn3 = bn3d(out)
        self.downsample = None
        if stride != 1 or in_channels != out:
            self.downsample = nn.Sequential(
                nn.Conv3d(in_channels, out, 1, stride=stride, bias=False), bn3d(out))

    def forward(self, x: torch.Tensor, src=None, dst=None) -> torch.Tensor:
        """``src`` / ``dst``: the input and output slabs on the space axis."""
        d = self.dtype
        y = torch.relu(batch_norm(conv3d(x, self.conv1, d, src, dst), self.bn1, d))
        y = torch.relu(batch_norm(conv3d(y, self.conv2, d, dst), self.bn2, d))
        y = batch_norm(conv3d(y, self.conv3, d, dst), self.bn3, d)
        if self.downsample is not None:
            x = batch_norm(conv3d(x, self.downsample[0], d, src, dst), self.downsample[1], d)
        return torch.relu(y + x)


class ResNetFPN(nn.Module):
    """Stem, bottleneck stages and the built-in FPN; returns one
    ``out_channels`` feature map per stage, finest first."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), in_dim: int = 4,
                 base_width: int = 64, out_channels: int = 256, stem_stride: int = 2,
                 is_max_pool: bool = True, upsample: str = "nearest",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_channels = out_channels
        self.is_max_pool = is_max_pool
        self.upsample = {"nearest": upsample_nearest, "trilinear": upsample_trilinear}[upsample]
        stem = stem_stride * (2 if is_max_pool else 1)
        self.strides = tuple(stem * 2 ** i for i in range(len(layers)))
        self.conv1 = nn.Conv3d(in_dim, base_width, 7, stride=stem_stride, padding=3, bias=False)
        self.bn1 = bn3d(base_width)
        self.layers = nn.ModuleList()
        widths, c = [], base_width
        for i, depth in enumerate(layers):
            planes = base_width * 2 ** i
            blocks = []
            for j in range(depth):
                blocks.append(Bottleneck(c, planes, 2 if (i > 0 and j == 0) else 1, dtype))
                c = planes * Bottleneck.expansion
            self.layers.append(nn.Sequential(*blocks))
            widths.append(c)
        n = len(layers)
        self.latlayers = nn.ModuleList(nn.Conv3d(widths[n - 1 - k], out_channels, 1)
                                       for k in range(n))
        self.smooths = nn.ModuleList(nn.Conv3d(out_channels, out_channels, 3, padding=1)
                                     for _ in range(n - 1))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                space=None) -> tuple[torch.Tensor, ...]:
        """``generator`` is unused: the CNN backbones draw nothing.
        ``space``: ``x``'s slabs on the space axis; each level is then this
        rank's slab of :meth:`level_slabs`."""
        if space is not None:
            return self._forward_slabs(x, space)
        y = self.stem(x)
        c_out = []
        for stage in self.layers:
            y = stage(y)
            c_out.append(y)
        return self.top_down(c_out)

    def _extents(self, x_extent: int) -> list[int]:
        """Global x extents: the stem conv's, the stem pool's (or the stem
        again without one) and each stage's."""
        k, s, p = self.conv1.kernel_size[0], self.conv1.stride[0], self.conv1.padding[0]
        e = [(x_extent + 2 * p - k) // s + 1]
        e.append((e[0] - 1) // 2 + 1 if self.is_max_pool else e[0])
        for i in range(len(self.layers)):
            e.append(e[-1] if i == 0 else (e[-1] - 1) // 2 + 1)
        return e

    def level_slabs(self, src) -> list:
        """The slabs of each output level, for the input slabs ``src``."""
        return [src.even(e) for e in self._extents(src.extent)[2:]]

    def _forward_slabs(self, x: torch.Tensor, src) -> tuple[torch.Tensor, ...]:
        d = self.dtype
        stem, pooled, *levels = [src.even(e) for e in self._extents(src.extent)]
        y = torch.relu(batch_norm(conv3d(x, self.conv1, d, src, stem), self.bn1, d))
        if self.is_max_pool:
            y = max_pool_slab(y, stem, pooled, 3, 2, 1)
        at, c_out = pooled, []
        for stage, level in zip(self.layers, levels):
            for j, block in enumerate(stage):
                y = block(y, at if j == 0 else level, level)
            at = level
            c_out.append(y)
        return self.top_down(c_out, levels)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(batch_norm(conv3d(x, self.conv1, self.dtype), self.bn1, self.dtype))
        return stem_pool(y) if self.is_max_pool else y

    def top_down(self, c_out: Sequence[torch.Tensor],
                 slabs: Sequence | None = None) -> tuple[torch.Tensor, ...]:
        """The built-in FPN: laterals, the top-down sums and the smooths
        (``slabs``: the levels' slabs on the space axis)."""
        d, n = self.dtype, len(c_out)
        slabs = slabs or [None] * n
        laterals = [conv3d(c_out[i], self.latlayers[n - 1 - i], d, slabs[i]) for i in range(n)]
        p = [laterals[-1]]
        for i in range(n - 2, -1, -1):
            if slabs[i] is None:
                up = self.upsample(p[0], laterals[i].shape[1:4])
            elif self.upsample is upsample_nearest:
                up = upsample_nearest_slab(p[0], slabs[i + 1], slabs[i],
                                           laterals[i].shape[2:4])
            else:
                raise NotImplementedError("the trilinear top-down path has no space-axis "
                                          "form; the RPN backbones resnet / resnet_tiny "
                                          "upsample nearest")
            p.insert(0, laterals[i] + up)
        for i in range(n - 1):
            p[i] = conv3d(p[i], self.smooths[n - 2 - i], d, slabs[i])
        return tuple(p)

    def flax_names(self) -> dict[str, str]:
        """Torch module name -> the JAX module's (``/``-joined)."""
        names = {"conv1": "stem_conv", "bn1": "stem_bn"}
        for i, stage in enumerate(self.layers):
            for j, block in enumerate(stage):
                t, f = f"layers.{i}.{j}", f"stage{i}_block{j}"
                for k in (1, 2, 3):
                    names[f"{t}.conv{k}"] = f"{f}/conv{k}"
                    names[f"{t}.bn{k}"] = f"{f}/bn{k}"
                if block.downsample is not None:
                    names[f"{t}.downsample.0"] = f"{f}/downsample_conv"
                    names[f"{t}.downsample.1"] = f"{f}/downsample_bn"
        n = len(self.layers)
        names.update({f"latlayers.{k}": f"lateral_{n - 1 - k}" for k in range(n)})
        names.update({f"smooths.{i}": f"smooth_{n - 2 - i}" for i in range(n - 1)})
        return names


class ResNetFPN256(ResNetFPN):
    """The ResNet-50-style backbone with the 7^3 stride-2 stem and a
    nearest top-down path."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), in_dim: int = 4,
                 base_width: int = 64, out_channels: int = 256, is_max_pool: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(layers, in_dim, base_width, out_channels, 2, is_max_pool,
                         "nearest", dtype)


class ResNetFPN64(ResNetFPN):
    """The small-input backbone: stride-1 stem of width 16, no pool, a
    trilinear top-down path."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), in_dim: int = 4,
                 out_channels: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__(layers, in_dim, 16, out_channels, 1, False, "trilinear", dtype)


class ResNetSimplified(nn.Module):
    """Stem (7^3 conv with bias, BN, ReLU; stride 2 and the stem pool with
    ``stride2_stem``) and ``num_residuals`` basic blocks (two 3^3 conv +
    BN, ReLU after the sum); one output level."""

    def __init__(self, out_channels: int = 64, num_residuals: int = 3,
                 stride2_stem: bool = False, in_dim: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_channels = out_channels
        self.stride2_stem = stride2_stem
        self.strides = (4 if stride2_stem else 1,)
        self.conv1 = nn.Conv3d(in_dim, out_channels, 7, stride=2 if stride2_stem else 1,
                               padding=3)
        self.bn1 = bn3d(out_channels)
        self.residuals = nn.ModuleList(
            nn.ModuleDict({"conv1": nn.Conv3d(out_channels, out_channels, 3, padding=1),
                           "bn1": bn3d(out_channels),
                           "conv2": nn.Conv3d(out_channels, out_channels, 3, padding=1),
                           "bn2": bn3d(out_channels)})
            for _ in range(num_residuals))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> tuple[torch.Tensor, ...]:
        d = self.dtype
        y = torch.relu(batch_norm(conv3d(x, self.conv1, d), self.bn1, d))
        if self.stride2_stem:
            y = stem_pool(y)
        for r in self.residuals:
            t = torch.relu(batch_norm(conv3d(y, r["conv1"], d), r["bn1"], d))
            t = batch_norm(conv3d(t, r["conv2"], d), r["bn2"], d)
            y = torch.relu(t + y)
        return (y,)

    def flax_names(self) -> dict[str, str]:
        names = {"conv1": "stem_conv", "bn1": "stem_bn"}
        for i in range(len(self.residuals)):
            for part in ("conv1", "bn1", "conv2", "bn2"):
                names[f"residuals.{i}.{part}"] = f"res{i}_{part}"
        return names
