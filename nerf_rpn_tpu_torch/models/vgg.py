"""3D VGG-FPN backbone (port of ``nerf_rpn_tpu/models/vgg.py``).

Channels-last ``(B, X, Y, Z, C)`` activations; BatchNorms with flax's
arithmetic (``models/layers.batch_norm``).  ``VGG_CFGS`` lists the convs of
each configuration, ``"M"`` a 2^3 ceil-mode max pool and ``"F"`` the end of
a pyramid stage.  The stem is a 7^3 stride-2 conv (with bias), BN, ReLU and
the 3^3 stride-2 stem pool when ``input_size >= 160``, else a stride-1 7^3
conv, BN and ReLU -- so below 160 the levels sit at strides (1, 2, 4, 8),
not (4, 8, 16, 32).  ``conv_at_start`` adds a 32-channel pre-stem whose 4x
downsampled skip joins the first stage's feature.  An FPN neck maps the
stages' (128, 256, 512, 512) channels to ``out_channels``.

Module names are the reference torch keys that
``nerf_rpn_tpu/tools/convert_weights.convert_vgg_fpn`` reads: the stem at
``layers.0`` (conv), ``layers.1`` (BN), then ``layers.2`` (ReLU) and, at
160 and above, ``layers.3`` (pool); each stage a nested
``layers.{stem_len + f}.{i}`` of conv, BN, ReLU and pool modules;
``starting_layers.*``, ``ds_layers.*`` and ``fpn_neck.{lateral_convs,
fpn_convs}.*``.  ``flax_names`` maps them onto the JAX module's names.
The JAX stem's TPU forms and the ``NERF_RPN_TPU_POOL2_REGROUP`` knob are
not ported: the pools are ``ops/pooling.py``'s.

On the ``space`` axis (``parallel/space.py``) ``VGGFPN.forward`` takes a
slab of the grid (``space=`` its input slabs) and gives each level on even
slabs of its global x extent (:meth:`VGGFPN.level_slabs`): every conv
fetches its input rows (``layers.conv3d`` given slabs), the stem pool its
-inf-padded ones and the 2^3 ceil-mode pools theirs, -inf past the global
edge (``pooling.max_pool_slab``); the FPN neck takes the levels' slabs.
"""

from __future__ import annotations

import torch
from torch import nn

from nerf_rpn_tpu_torch.models.fpn import FPN
from nerf_rpn_tpu_torch.models.layers import batch_norm, bn3d, conv3d
from nerf_rpn_tpu_torch.ops.pooling import max_pool_2x2x2, max_pool_slab, stem_pool
from nerf_rpn_tpu_torch.parallel import space as sp

VGG_CFGS: dict[str, tuple] = {
    "AF": (64, 128, "F", 256, 256, "M", "F", 512, 512, "M", "F", 512, 512, "M", "F"),
    "DF": (64, 64, 128, 128, "F", 256, 256, 256, "M", "F", 512, 512, 512, "M", "F",
           512, 512, 512, "M", "F"),
    "EF": (64, 64, 128, 128, "F", 256, 256, 256, 256, "M", "F",
           512, 512, 512, 512, "M", "F", 512, 512, 512, 512, "M", "F"),
}


class CNNSequence(nn.Sequential):
    """Conv, BatchNorm, ReLU and max-pool modules applied in order on
    channels-last tensors through the port's layer helpers (flax's dtype
    and BatchNorm semantics); the 3^3 pool is the stem pool, the 2^3 one
    the ceil-mode pool."""

    def __init__(self, *modules: nn.Module, dtype: torch.dtype = torch.float32):
        super().__init__(*modules)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return run_modules(self, x, self.dtype)[0]


def run_modules(modules, x: torch.Tensor, dtype: torch.dtype,
                slab: "sp.Slab | None" = None) -> tuple[torch.Tensor, "sp.Slab | None"]:
    """Apply ``modules`` in order to channels-last ``x`` (see
    :class:`CNNSequence`); modules without arithmetic (``nn.Identity``)
    pass ``x`` through.  ``slab``: ``x``'s slabs on the space axis, where
    each conv and pool fetches its input rows and puts its output on even
    slabs of its global x extent.  Returns the output and its slabs (None
    off the axis)."""
    for m in modules:
        if isinstance(m, nn.Conv3d):
            out = None if slab is None else slab.even(_out_extent(m, slab.extent))
            x, slab = conv3d(x, m, dtype, slab, out), out
        elif isinstance(m, nn.BatchNorm3d):
            x = batch_norm(x, m, dtype)
        elif isinstance(m, nn.ReLU):
            x = torch.relu(x)
        elif isinstance(m, nn.MaxPool3d):
            stem = m.kernel_size == 3
            if slab is None:
                x = stem_pool(x) if stem else max_pool_2x2x2(x, ceil_mode=True)
                continue
            out = slab.even(_out_extent(m, slab.extent))
            x = (max_pool_slab(x, slab, out, 3, 2, 1) if stem else
                 max_pool_slab(x, slab, out, 2, 2, 0, ceil_mode=True))
            slab = out
    return x, slab


def _out_extent(m: nn.Module, extent: int) -> int:
    """The x extent after a conv or pool module (others keep it)."""
    if isinstance(m, nn.Conv3d):
        return (extent + 2 * m.padding[0] - m.kernel_size[0]) // m.stride[0] + 1
    if isinstance(m, nn.MaxPool3d):
        return (extent - 1) // 2 + 1 if m.kernel_size == 3 else -(-extent // 2)
    return extent


class VGGFPN(nn.Module):
    """VGG 3D conv backbone + FPN neck: 4 levels of ``out_channels``."""

    def __init__(self, cfg: str = "AF", in_dim: int = 4, batch_norm: bool = True,
                 input_size: int = 160, conv_at_start: bool = False,
                 out_channels: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_channels = out_channels
        self.conv_at_start = conv_at_start
        big = input_size >= 160
        self.strides = (4, 8, 16, 32) if big else (1, 2, 4, 8)

        def cbr(cin, cout, kernel=3, stride=1):
            mods = [nn.Conv3d(cin, cout, kernel, stride=stride, padding=kernel // 2)]
            return mods + ([bn3d(cout)] if batch_norm else []) + [nn.ReLU()]

        c = in_dim
        if conv_at_start:
            self.starting_layers = CNNSequence(*cbr(c, 32), *cbr(32, 32), dtype=dtype)
            self.ds_layers = CNNSequence(*cbr(32, 32, stride=2), *cbr(32, 32, stride=2),
                                         *cbr(32, 128, kernel=1), dtype=dtype)
            c = 32
        # the stem keeps the reference's indices with or without its BN
        stem = [nn.Conv3d(c, 64, 7, stride=2 if big else 1, padding=3),
                bn3d(64) if batch_norm else nn.Identity(), nn.ReLU()]
        if big:
            stem.append(nn.MaxPool3d(3, 2, 1))
        stages, block, c = [], [], 64
        for v in VGG_CFGS[cfg]:
            if v == "M":
                block.append(nn.MaxPool3d(2, 2, ceil_mode=True))
            elif v == "F":
                stages.append(CNNSequence(*block, dtype=dtype))
                block = []
            else:
                block += cbr(c, int(v))
                c = int(v)
        self.layers = nn.Sequential(*stem, *stages)
        self.stem_len = len(stem)
        self.fpn_neck = FPN((128, 256, 512, 512), out_channels, dtype)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                space: "sp.Slab | None" = None) -> tuple[torch.Tensor, ...]:
        """``generator`` is unused: the CNN backbones draw nothing.
        ``space``: ``x``'s slabs on the space axis; each level is then this
        rank's slab of :meth:`level_slabs`."""
        y, skip, slab = self.stem(x, space)
        features, slabs = [], []
        for stage in self.layers[self.stem_len:]:
            if slab is None:  # the module's call: forward hooks see it
                y = stage(y)
            else:
                y, slab = run_modules(stage, y, self.dtype, slab)
            features.append(y)
            slabs.append(slab)
        if skip is not None:
            features[0] = features[0] + skip
        return self.fpn_neck(features[-4:], slabs[-4:] if space is not None else None)

    def level_slabs(self, src: "sp.Slab") -> list:
        """The slabs of each output level (even slabs of its global x
        extent), for the input slabs ``src``."""
        extent, out = src.extent, []
        for m in self.layers[:self.stem_len]:
            extent = _out_extent(m, extent)
        for stage in self.layers[self.stem_len:]:
            for m in stage:
                extent = _out_extent(m, extent)
            out.append(src.even(extent))
        return out[-4:]

    def stem(self, x: torch.Tensor, slab: "sp.Slab | None" = None):
        """The stem's output, ``conv_at_start``'s downsampled skip (or
        None) and the output's slabs (None off the space axis)."""
        skip = None
        if self.conv_at_start:
            x, slab_x = run_modules(self.starting_layers, x, self.dtype, slab)
            skip = run_modules(self.ds_layers, x, self.dtype, slab_x)[0]
            slab = slab_x
        y, slab = run_modules(self.layers[:self.stem_len], x, self.dtype, slab)
        return y, skip, slab

    def flax_names(self) -> dict[str, str]:
        """Torch module name -> the JAX module's (``/``-joined)."""
        names = {"layers.0": "stem_conv"}
        if isinstance(self.layers[1], nn.BatchNorm3d):
            names["layers.1"] = "stem_bn"
        li = 0
        for f, stage in enumerate(self.layers[self.stem_len:]):
            for i, m in enumerate(stage):
                if isinstance(m, nn.Conv3d):
                    names[f"layers.{self.stem_len + f}.{i}"] = f"layer{li}_conv"
                elif isinstance(m, nn.BatchNorm3d):
                    names[f"layers.{self.stem_len + f}.{i}"] = f"layer{li}_bn"
                if isinstance(m, nn.ReLU):
                    li += 1
        if self.conv_at_start:
            for part, seq, flax in (("starting_layers", self.starting_layers, "start"),
                                    ("ds_layers", self.ds_layers, "ds")):
                k = 0
                for i, m in enumerate(seq):
                    if isinstance(m, nn.Conv3d):
                        names[f"{part}.{i}"] = f"{flax}{k}_conv"
                    elif isinstance(m, nn.BatchNorm3d):
                        names[f"{part}.{i}"] = f"{flax}{k}_bn"
                    else:
                        k += 1
        for i in range(len(self.fpn_neck.lateral_convs)):
            names[f"fpn_neck.lateral_convs.{i}"] = f"fpn_neck/lateral_{i}"
            names[f"fpn_neck.fpn_convs.{i}"] = f"fpn_neck/output_{i}"
        return names
