"""3D Swin Transformer FPN backbone (port of ``nerf_rpn_tpu/models/swin.py``).

Channels-last ``(B, X, Y, Z, C)`` activations like the JAX package.
Parameter names follow the reference torch state-dict keys that
``nerf_rpn_tpu/tools/convert_weights.convert_swin_fpn`` reads:
``patch_partition.{0,2}``, ``stages.{i}.{j}`` (``stages.{i}.0`` is the patch
merging of stages i > 0), ``attn.qkv``, ``attn.proj``,
``attn.relative_position_bias_table``, ``mlp.0`` / ``mlp.3`` and
``fpn_neck.{lateral_convs,fpn_convs}.{i}``.

A block follows ``self.training``:

- train mode (``module.train()``): the plain chain -- LayerNorm, pad, roll,
  partition, qkv dense, ``ops.window_attention.WindowAttention`` (kernel K1
  forward, kernel K2 backward on CUDA), proj, reverse, and the MLP with
  ``erf_gelu`` -- and each block drops its residual branches per sample
  (stochastic depth) with a keep mask drawn from the generator passed to
  ``forward``;
- eval mode: the fused route, where stochastic depth is the identity.
  Kernel K5 (``ops.fused_ln_qkv``) builds the windowed qkv from the raw
  block input with the pad and roll inside; the attention is kernel K1 where
  the block's shift is off and kernel K4 (``fused_window_attention``, the
  shift mask as a pattern table) where it is on; then proj, reverse, roll
  back, crop and the residual; kernel K6 (``ops.fused_mlp``) computes the
  MLP half.  None of K4-K6 has a backward: a gradient asked through the
  eval route raises.  On CPU tensors every kernel is its plain twin.

On the ``space`` axis (``parallel/space.py``; ``SwinFPN.forward(...,
space=)``) each stage works on window-aligned slabs: the ``ceil(X_s / w)``
padded window columns split over the space group as evenly as the count
allows (:meth:`SwinFPN.level_slabs`; a deep stage may leave a rank none).
The patch embed fetches whole patches in XLA's SAME-padded frame; a block
whose shift is on along x fetches the rolled frame's rows of its columns
(``space.reshard_x``, a wrapped map: the last slab holds the global pad
rows between real rows) and rolls y and z in place, K5 taking the slab's
place in the global grid (``ops.fused_ln_qkv.XSlab``); the shift mask and
K4's pattern ids are sliced to the slab's windows; the output goes back to
the block's slab by the inverse map.  Patch merging fetches its even pairs,
the odd pad on the last slab only.  K1, K2, K4 and K6 run on the slab
unchanged, and nothing launches where a slab holds no windows.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf_rpn_tpu_torch.models.fpn import FPN
from nerf_rpn_tpu_torch.models.layers import dense, layer_norm
from nerf_rpn_tpu_torch.ops.activations import erf_gelu
from nerf_rpn_tpu_torch.ops.fused_ln_qkv import XSlab, ln_partition_qkv
from nerf_rpn_tpu_torch.ops.fused_mlp import fused_mlp_block
from nerf_rpn_tpu_torch.ops.window_attention import (
    WindowAttention,
    fused_window_attention,
    window_attention,
)
from nerf_rpn_tpu_torch.parallel import space as sp

SWIN_VARIANTS = {
    "swin_t": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "swin_s": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "swin_b": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "swin_l": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
}


@lru_cache(maxsize=None)
def relative_position_index(window: tuple[int, int, int]) -> np.ndarray:
    """Flat (N*N,) index into the (2w-1)^3 bias table for each token pair
    (the reference's row-major packing; copy of the JAX package's numpy)."""
    wx, wy, wz = window
    coords = np.stack(
        np.meshgrid(np.arange(wx), np.arange(wy), np.arange(wz), indexing="ij")
    ).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wx - 1
    rel[:, :, 1] += wy - 1
    rel[:, :, 2] += wz - 1
    rel[:, :, 0] *= (2 * wz - 1) * (2 * wy - 1)
    rel[:, :, 1] *= 2 * wz - 1
    return rel.sum(-1).reshape(-1)


@lru_cache(maxsize=None)
def shift_attn_mask(pad_size: tuple[int, int, int], window: tuple[int, int, int],
                    shift: tuple[int, int, int]) -> np.ndarray | None:
    """(nW, N, N) additive mask, -100 where two tokens come from different
    pre-shift regions; None when no shift is active."""
    if sum(shift) == 0:
        return None
    px, py, pz = pad_size
    region = np.zeros(pad_size, np.float32)
    count = 0
    for xs in ((0, px - window[0]), (px - window[0], px - shift[0]), (px - shift[0], px)):
        for ys in ((0, py - window[1]), (py - window[1], py - shift[1]), (py - shift[1], py)):
            for zs in ((0, pz - window[2]), (pz - window[2], pz - shift[2]), (pz - shift[2], pz)):
                region[xs[0]:xs[1], ys[0]:ys[1], zs[0]:zs[1]] = count
                count += 1
    nx, ny, nz = px // window[0], py // window[1], pz // window[2]
    region = region.reshape(nx, window[0], ny, window[1], nz, window[2])
    region = region.transpose(0, 2, 4, 1, 3, 5).reshape(nx * ny * nz, -1)
    diff = region[:, None, :] - region[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=None)
def shift_mask_patterns(pad_size: tuple[int, int, int], window: tuple[int, int, int],
                        shift: tuple[int, int, int]) -> tuple[np.ndarray, np.ndarray]:
    """The shift mask as kernel K4 takes it: ``(P, N, N)`` distinct patterns
    and the ``(nW,)`` int32 pattern id of each window (P <= 8 for a 3D
    shift).  Requires an active shift."""
    m = shift_attn_mask(pad_size, window, shift)
    table, ids = np.unique(m.reshape(m.shape[0], -1), axis=0, return_inverse=True)
    return table.reshape(-1, *m.shape[1:]), ids.reshape(-1).astype(np.int32)


class _EvalOnly(torch.autograd.Function):
    """``apply(name, fn, *args)`` runs ``fn(*args)``, an eval kernel with no
    backward; asking for its gradient raises instead of dropping it."""

    @staticmethod
    def forward(ctx, name, fn, *args):
        ctx.name = name
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.name} is an eval kernel without a backward; gradients flow "
            "through the train-mode chain (module.train())")


def window_partition(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """(B, X, Y, Z, C) -> (B * nW, N, C), windows batch-major."""
    b, px, py, pz, c = x.shape
    wx, wy, wz = window
    x = x.reshape(b, px // wx, wx, py // wy, wy, pz // wz, wz, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b * (px // wx) * (py // wy) * (pz // wz), wx * wy * wz, c)


def window_reverse(x: torch.Tensor, window: Sequence[int], b: int,
                   pad_size: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    px, py, pz = pad_size
    wx, wy, wz = window
    c = x.shape[-1]
    x = x.reshape(b, px // wx, py // wy, pz // wz, wx, wy, wz, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, px, py, pz, c)


class ShiftedWindowAttention3D(nn.Module):
    """3D W-MSA with relative position bias and an optional cyclic shift."""

    def __init__(self, dim: int, window: tuple[int, int, int],
                 shift: tuple[int, int, int], num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not divisible by {num_heads} heads")
        self.window, self.shift = tuple(window), tuple(shift)
        self.num_heads, self.dtype = num_heads, dtype
        wx, wy, wz = self.window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wx - 1) * (2 * wy - 1) * (2 * wz - 1), num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(self.window)),
            persistent=False)
        # (pad_size, shift, device) -> (nW, N, N) f32 mask or None;
        # (pad_size, shift, device, batch) -> K4's (table, ids)
        self._masks: dict = {}
        self._patterns: dict = {}

    def _mask(self, pad_size, shift, device, windows=None) -> torch.Tensor | None:
        """The shift mask; ``windows``: the (first, stop) global window
        indices of a slab, whose rows alone it keeps."""
        key = (pad_size, shift, device, windows)
        if key not in self._masks:
            m = shift_attn_mask(pad_size, self.window, shift)
            if m is not None and windows is not None:
                m = m[windows[0]:windows[1]]
            self._masks[key] = None if m is None else torch.from_numpy(m).to(device)
        return self._masks[key]

    def _pattern_table(self, pad_size, shift, device, batch, windows=None):
        """K4's mask table and the pattern ids (of the global windows
        ``windows``, all without) tiled over the batch."""
        key = (pad_size, shift, device, batch, windows)
        if key not in self._patterns:
            table, ids = shift_mask_patterns(pad_size, self.window, shift)
            if windows is not None:
                ids = ids[windows[0]:windows[1]]
            self._patterns[key] = (torch.from_numpy(table).to(device),
                                   torch.from_numpy(np.tile(ids, batch)).to(device))
        return self._patterns[key]

    def _geometry(self, size) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """Padded grid size and the shift (off along an axis that one
        window covers)."""
        pad_size = tuple(-(-s // w) * w for s, w in zip(size, self.window))
        shift = tuple(0 if w >= p else s
                      for s, w, p in zip(self.shift, self.window, pad_size))
        return pad_size, shift

    def _bias(self) -> torch.Tensor:
        n = int(np.prod(self.window))
        bias = self.relative_position_bias_table[self.relative_position_index]
        return bias.reshape(n, n, self.num_heads).permute(2, 0, 1)

    def _output(self, y: torch.Tensor, b: int, size, pad_size, shift) -> torch.Tensor:
        """proj, window reverse, roll back, crop."""
        y = dense(y, self.proj, self.dtype)
        y = window_reverse(y, self.window, b, pad_size)
        if sum(shift):
            y = torch.roll(y, shift, dims=(1, 2, 3))
        return y[:, :size[0], :size[1], :size[2]]

    def _slab_geometry(self, slab: "sp.Slab", sy: int, sz: int):
        """The block's geometry on a window-aligned slab: the global padded
        size and shift, this rank's global windows, each rank's rows of the
        rolled frame (``rolled``: the source row of each, -1 for a pad row;
        ``frame``: their slabs) and the inverse map back to the slabs."""
        pad_size, shift = self._geometry((slab.extent, sy, sz))
        w, p, s = self.window[0], pad_size[0], shift[0]
        per_col = (pad_size[1] // self.window[1]) * (pad_size[2] // self.window[2])
        frame = sp.Slab(slab.groups, tuple((a * w, b * w) for a, b in slab.cols), p)

        def source(j):
            q = (j + s) % p
            return q if q < slab.extent else -1

        rolled = [tuple(source(j) for j in range(a, b)) for a, b in frame.bounds]
        back = [tuple((q - s) % p for q in range(a, b)) for a, b in slab.bounds]
        windows = (slab.col_lo * per_col, slab.col_hi * per_col)
        return pad_size, shift, windows, frame, rolled, back

    def _output_slab(self, y: torch.Tensor, b: int, sy: int, sz: int, pad_size, shift,
                     frame: "sp.Slab", back) -> torch.Tensor:
        """proj, window reverse, roll y and z back, crop, and the rolled
        frame's rows back to the block's slabs."""
        y = dense(y, self.proj, self.dtype)
        y = window_reverse(y, self.window, b, (frame.rows, *pad_size[1:]))
        if shift[1] or shift[2]:
            y = torch.roll(y, shift[1:], dims=(2, 3))
        return sp.reshard_x(y[:, :, :sy, :sz], frame, back)

    def _forward_slab(self, x: torch.Tensor, slab: "sp.Slab") -> torch.Tensor:
        b, _, sy, sz, c = x.shape
        pad_size, shift, windows, frame, rolled, back = self._slab_geometry(slab, sy, sz)
        x = sp.reshard_x(x, slab, rolled)  # the LayerNorm'd pad rows are zero
        x = F.pad(x, (0, 0, 0, pad_size[2] - sz, 0, pad_size[1] - sy))
        if shift[1] or shift[2]:
            x = torch.roll(x, (-shift[1], -shift[2]), dims=(2, 3))
        qkv = dense(window_partition(x, self.window), self.qkv, self.dtype)
        if qkv.shape[0]:
            y = WindowAttention.apply(qkv, self._bias(),
                                      self._mask(pad_size, shift, x.device, windows),
                                      self.num_heads)
        else:
            y = sp.keep_graph_empty((0, qkv.shape[1], c), qkv, self.relative_position_bias_table)
        return self._output_slab(y, b, sy, sz, pad_size, shift, frame, back)

    def forward(self, x: torch.Tensor, slab: "sp.Slab | None" = None) -> torch.Tensor:
        """Train-mode chain on the LayerNorm'd block input (``slab``: its
        window-aligned slabs on the space axis)."""
        if slab is not None:
            return self._forward_slab(x, slab)
        b, sx, sy, sz, c = x.shape
        pad_size, shift = self._geometry((sx, sy, sz))
        pad = [p - s for p, s in zip(pad_size, (sx, sy, sz))]
        if any(pad):
            x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        if sum(shift):
            x = torch.roll(x, (-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
        qkv = dense(window_partition(x, self.window), self.qkv, self.dtype)
        y = WindowAttention.apply(qkv, self._bias(), self._mask(pad_size, shift, x.device),
                                  self.num_heads)
        return self._output(y, b, (sx, sy, sz), pad_size, shift)

    def forward_eval(self, x: torch.Tensor, norm: nn.LayerNorm,
                     slab: "sp.Slab | None" = None) -> torch.Tensor:
        """Eval route on the raw block input: K5 (LN ``norm`` + pad + roll
        + partition + qkv), then K1 (no shift) or K4 (shift).  ``slab``:
        the input's window-aligned slabs on the space axis, where K5 reads
        the rolled frame's rows (fetched where the shift is on along x) at
        their place in the global grid."""
        b, sx, sy, sz, c = x.shape
        windows = k5_slab = None
        if slab is None:
            pad_size, shift = self._geometry((sx, sy, sz))
        else:
            pad_size, shift, windows, frame, rolled, back = self._slab_geometry(slab, sy, sz)
            origin = slab.lo  # the global row of x's first row
            if shift[0]:
                x = sp.reshard_x(x, slab, rolled)  # pad rows: K5 never reads them
                origin = slab.col_lo * self.window[0] + shift[0]
            k5_slab = XSlab(origin % pad_size[0], slab.extent, slab.col_lo,
                            slab.col_hi - slab.col_lo)
        qkv = _EvalOnly.apply(
            "K5 ln_partition_qkv", ln_partition_qkv, x, norm.weight,
            norm.bias, self.qkv.weight.t(), self.qkv.bias, self.window, pad_size, shift,
            k5_slab)
        if not sum(shift):
            y = _EvalOnly.apply("K1 window_attention", window_attention, qkv,
                                self._bias(), None, self.num_heads)
        else:
            w, n = qkv.shape[:2]
            q, k, v = qkv.view(w, n, 3, self.num_heads, c // self.num_heads).permute(
                2, 0, 3, 1, 4)
            table, ids = self._pattern_table(pad_size, shift, x.device, b, windows)
            y = _EvalOnly.apply("K4 fused_window_attention", fused_window_attention,
                                q, k, v, self._bias(), table, ids)
            y = y.transpose(1, 2).reshape(w, n, c)
        if slab is None:
            return self._output(y, b, (sx, sy, sz), pad_size, shift)
        return self._output_slab(y, b, sy, sz, pad_size, shift, frame, back)


def stochastic_depth(y: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Drop whole samples of a residual branch: a per-sample Bernoulli keep
    mask of shape (B, 1, ..., 1) (uniform < keep, as ``jax.random.bernoulli``
    draws it) and ``y * mask / keep`` in y's dtype."""
    keep = 1.0 - rate
    u = torch.rand((y.shape[0],) + (1,) * (y.dim() - 1), generator=generator,
                   device=generator.device)
    return y * (u < keep).to(device=y.device, dtype=y.dtype) / keep


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: tuple[int, int, int],
                 shift: tuple[int, int, int], mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ShiftedWindowAttention3D(dim, window, shift, num_heads, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        hidden = int(dim * mlp_ratio)
        # indices follow the reference keys mlp.0 (fc1) / mlp.3 (fc2); the
        # GELU and dropout slots between them hold no parameters
        self.mlp = nn.ModuleList(
            [nn.Linear(dim, hidden), nn.Identity(), nn.Identity(),
             nn.Linear(hidden, dim)])

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                slab: "sp.Slab | None" = None) -> torch.Tensor:
        """``slab``: ``x``'s window-aligned slabs on the space axis."""
        if not self.training:
            return self.forward_eval(x, slab)

        def drop(y):
            if self.drop_path == 0.0:
                return y
            if generator is None:
                raise ValueError("train mode needs a generator for stochastic depth")
            return stochastic_depth(y, self.drop_path, generator)

        x = x + drop(self.attn(layer_norm(x, self.norm1, self.dtype), slab))
        h = dense(layer_norm(x, self.norm2, self.dtype), self.mlp[0], self.dtype)
        h = dense(erf_gelu(h), self.mlp[3], self.dtype)
        return x + drop(h)

    def forward_eval(self, x: torch.Tensor, slab: "sp.Slab | None" = None) -> torch.Tensor:
        """Eval route: K5 + K1/K4 attention half, then K6 for the MLP half."""
        x = x + self.attn.forward_eval(x, self.norm1, slab)
        fc1, fc2 = self.mlp[0], self.mlp[3]
        y = _EvalOnly.apply(
            "K6 fused_mlp_block", fused_mlp_block, x.reshape(-1, x.shape[-1]),
            self.norm2.weight, self.norm2.bias, fc1.weight.t(), fc1.bias,
            fc2.weight.t(), fc2.bias)
        return y.reshape(x.shape)


class PatchMerging3D(nn.Module):
    """8-neighbour concat -> LayerNorm -> Linear(8C -> 2C), odd sizes padded."""

    def __init__(self, dim: int, expand: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(8 * dim, eps=1e-5)
        self.reduction = nn.Linear(8 * dim, 2 * dim if expand else dim, bias=False)

    def forward(self, x: torch.Tensor, src: "sp.Slab | None" = None,
                dst: "sp.Slab | None" = None) -> torch.Tensor:
        """``src`` / ``dst``: the input's and the output's slabs on the
        space axis; each rank fetches the pairs of its output rows, the
        odd pad a zero row past the global extent."""
        b, sx, sy, sz, c = x.shape
        if src is not None:
            pairs = [tuple(g if g < src.extent else -1 for g in range(2 * a, 2 * e))
                     for a, e in dst.bounds]
            x = sp.reshard_x(x, src, pairs)
            sx = 0
        if sx % 2 or sy % 2 or sz % 2:
            x = F.pad(x, (0, 0, 0, sz % 2, 0, sy % 2, 0, sx % 2))
        nx, ny, nz = x.shape[1] // 2, x.shape[2] // 2, x.shape[3] // 2
        # channel block k*4 + j*2 + i for the (i, j, k) offset in (x, y, z):
        # the reference's concat order
        x8 = x.reshape(b, nx, 2, ny, 2, nz, 2, c).permute(0, 1, 3, 5, 6, 4, 2, 7)
        y = layer_norm(x8.reshape(b, nx, ny, nz, 8 * c), self.norm, self.dtype)
        return dense(y, self.reduction, self.dtype)


def same_pad(size: int, patch: int) -> tuple[int, int]:
    """XLA's SAME padding of a stride = kernel patch: (total // 2, rest)."""
    total = -(-size // patch) * patch - size
    return total // 2, total - total // 2


def patch_embed(x: torch.Tensor, conv: nn.Conv3d, dtype: torch.dtype,
                pad_x: bool = True) -> torch.Tensor:
    """Stride = kernel patch embed as space-to-depth + one matmul.

    The patch is flattened in the order (px, py, pz, c), the row-major
    flatten of the conv kernel's (kx, ky, kz, in) axes; indivisible grids
    get XLA's SAME padding (lo = total // 2) first, as in the JAX package
    (along x only with ``pad_x``: a slab's rows come padded).
    """
    px, py, pz = conv.kernel_size
    b, sx, sy, sz, c = x.shape
    pads = [same_pad(s, p) for s, p in zip((sx, sy, sz), (px, py, pz))]
    if not pad_x:
        pads[0] = (0, 0)
    if any(sum(p) for p in pads):
        x = F.pad(x, (0, 0, *pads[2], *pads[1], *pads[0]))
    b, sx, sy, sz, c = x.shape
    x = x.to(dtype).reshape(b, sx // px, px, sy // py, py, sz // pz, pz, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        b, sx // px, sy // py, sz // pz, px * py * pz * c)
    w = conv.weight.permute(0, 2, 3, 4, 1).reshape(conv.out_channels, -1)
    return F.linear(x, w.to(dtype), conv.bias.to(dtype))


class SwinFPN(nn.Module):
    """3D Swin backbone + FPN neck; returns a 4-level 256-channel pyramid."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 patch_size: tuple[int, int, int] = (4, 4, 4),
                 window: tuple[int, int, int] = (4, 4, 4), mlp_ratio: float = 4.0,
                 stochastic_depth_prob: float = 0.1, expand_dim: bool = True,
                 out_channels: int = 256, in_dim: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_channels = out_channels
        self.strides = tuple(patch_size[0] * 2 ** i for i in range(len(depths)))
        dims = [embed_dim * (2 ** i) if expand_dim else embed_dim
                for i in range(len(depths))]
        for dim, heads in zip(dims, num_heads):
            if dim % heads:
                # swin_b's table (embed 128, heads 3/6/12/24) fails here, as
                # it fails to initialise in the JAX package
                raise ValueError(
                    f"stage width {dim} is not divisible by {heads} heads")
        self.patch_partition = nn.ModuleList(
            [nn.Conv3d(in_dim, embed_dim, patch_size, stride=patch_size),
             nn.Identity(), nn.LayerNorm(embed_dim, eps=1e-5)])
        self.stages = nn.ModuleList()
        total_blocks, block_id = sum(depths), 0
        for i, depth in enumerate(depths):
            layers = []
            if i > 0:
                layers.append(PatchMerging3D(dims[i - 1], expand_dim, dtype))
            for j in range(depth):
                shift = tuple(0 if j % 2 == 0 else w // 2 for w in window)
                rate = stochastic_depth_prob * block_id / max(total_blocks - 1, 1)
                layers.append(SwinBlock(dims[i], num_heads[i], window, shift,
                                        mlp_ratio, rate, dtype))
                block_id += 1
            self.stages.append(nn.ModuleList(layers))
        self.fpn_neck = FPN(dims, out_channels, dtype)

    def level_slabs(self, src: "sp.Slab") -> list:
        """Each stage's window-aligned slabs for the grid's slabs ``src``."""
        p, w = self.patch_partition[0].kernel_size[0], self.stages[0][0].attn.window[0]
        extent, out = -(-src.extent // p), []
        for _ in self.stages:
            out.append(src.windows(extent, w))
            extent = -(-extent // 2)
        return out

    def _forward_slabs(self, x, generator, src: "sp.Slab") -> tuple[torch.Tensor, ...]:
        p = self.patch_partition[0].kernel_size[0]
        slabs = self.level_slabs(src)
        lo = same_pad(src.extent, p)[0]
        rows = [tuple(g if 0 <= g < src.extent else -1 for g in range(a * p - lo, e * p - lo))
                for a, e in slabs[0].bounds]
        y = patch_embed(sp.reshard_x(x, src, rows), self.patch_partition[0], self.dtype,
                        pad_x=False)
        y = layer_norm(y, self.patch_partition[2], self.dtype)
        features = []
        for i, stage in enumerate(self.stages):
            for layer in stage:
                if isinstance(layer, SwinBlock):
                    y = layer(y, generator, slabs[i])
                else:
                    y = layer(y, slabs[i - 1], slabs[i])
            features.append(y)
        return self.fpn_neck(features, slabs)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                space: "sp.Slab | None" = None) -> tuple[torch.Tensor, ...]:
        """``generator`` draws the stochastic-depth masks in train mode.
        ``space``: ``x``'s slabs on the space axis; each level is then this
        rank's slab of :meth:`level_slabs`."""
        if space is not None:
            return self._forward_slabs(x, generator, space)
        y = patch_embed(x, self.patch_partition[0], self.dtype)
        y = layer_norm(y, self.patch_partition[2], self.dtype)
        features = []
        for stage in self.stages:
            for layer in stage:
                y = layer(y, generator) if isinstance(layer, SwinBlock) else layer(y)
            features.append(y)
        return self.fpn_neck(features)


def make_swin_fpn(variant: str, **kw) -> SwinFPN:
    return SwinFPN(**SWIN_VARIANTS[variant], **kw)
