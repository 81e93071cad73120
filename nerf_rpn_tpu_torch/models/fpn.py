"""3D FPN neck (port of ``nerf_rpn_tpu/models/fpn.py``).

Lateral 1x1 convs, a nearest top-down upsample and 3x3 output convs, one
output per input level (the Swin FPN configuration; the extra-level options
of the JAX module are not ported).  Parameter names follow the reference
torch keys ``lateral_convs.i`` / ``fpn_convs.i``.

On the ``space`` axis (``parallel/space.py``) the levels are slabs: the
upsample reads its source rows by global coordinate
(:func:`upsample_nearest_slab`) and the 3^3 output convs take a halo of one
row (``layers.conv3d``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nerf_rpn_tpu_torch.models.layers import conv3d
from nerf_rpn_tpu_torch.parallel import space


def upsample_nearest(x: torch.Tensor, target_shape: Sequence[int]) -> torch.Tensor:
    """Nearest upsample of (B, X, Y, Z, C) to (X', Y', Z').

    ``jax.image.resize(method="nearest")`` samples at half-pixel centres,
    which is ``mode="nearest-exact"`` (not ``"nearest"``); at the bench
    shape level 3 goes 7 -> 13, which is not an exact 2x.
    """
    y = F.interpolate(x.permute(0, 4, 1, 2, 3), size=tuple(target_shape),
                      mode="nearest-exact")
    return y.permute(0, 2, 3, 4, 1)


def upsample_nearest_slab(x: torch.Tensor, src: "space.Slab", dst: "space.Slab",
                          target_yz: Sequence[int]) -> torch.Tensor:
    """:func:`upsample_nearest` of the slabs ``src`` to the slabs ``dst``
    (global x extents ``src.extent`` -> ``dst.extent``): each output row's
    source row by global coordinate, as ``F.interpolate`` picks it, then
    y and z in place."""
    pick = space.nearest_rows(src.extent, dst.extent)
    x = space.reshard_x(x, src, [pick[a:b] for a, b in dst.bounds])
    if x.shape[1] == 0:
        return space.keep_graph_empty((x.shape[0], 0, *target_yz, x.shape[-1]), x)
    return upsample_nearest(x, (x.shape[1], *target_yz))


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.lateral_convs = nn.ModuleList(
            nn.Conv3d(c, out_channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            nn.Conv3d(out_channels, out_channels, 3, padding=1)
            for _ in in_channels)

    def forward(self, inputs: Sequence[torch.Tensor],
                slabs: Sequence | None = None) -> tuple[torch.Tensor, ...]:
        """``slabs``: the levels' slabs on the space axis."""
        if len(inputs) != len(self.lateral_convs):
            raise ValueError(f"expected {len(self.lateral_convs)} levels, "
                             f"got {len(inputs)}")
        slabs = slabs or [None] * len(inputs)
        laterals = [conv3d(x, conv, self.dtype, s)
                    for x, conv, s in zip(inputs, self.lateral_convs, slabs)]
        for i in range(len(laterals) - 1, 0, -1):
            if slabs[i] is None:
                up = upsample_nearest(laterals[i], laterals[i - 1].shape[1:4])
            else:
                up = upsample_nearest_slab(laterals[i], slabs[i], slabs[i - 1],
                                           laterals[i - 1].shape[2:4])
            laterals[i - 1] = laterals[i - 1] + up
        return tuple(conv3d(x, conv, self.dtype, s)
                     for x, conv, s in zip(laterals, self.fpn_convs, slabs))
