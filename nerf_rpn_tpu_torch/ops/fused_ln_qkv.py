"""LayerNorm -> pad -> cyclic shift -> window partition -> qkv: kernel K5.

Port of ``ln_partition_qkv`` (``nerf_rpn_tpu/ops/fused_ln_qkv.py:110-172``,
the "flat" layout), the attention prologue of an eval Swin block::

    out[w, p] = round(LN(x)[src(w, p)] @ w_qkv + b)     (W, N, 3C)

LayerNorm over C with two-pass f32 statistics and eps 1e-5, its affine in
f32, rounded to x's dtype; the product accumulated in f32 and the f32 bias
added before the one rounding.  Where the JAX kernel takes an already padded
and rolled grid, this one takes the unpadded ``(B, X, Y, Z, C)`` grid with
the padded size and the shift: window token p reads voxel
``(coordinate + shift) mod pad_size``, and a voxel at or past the real size
is a zero LN output (its row is just ``b``), as the model pads after the
LayerNorm.  With shift 0 and a divisible grid it is the JAX function.

``ln_partition_qkv`` launches the CUDA kernel (``csrc/fused_ln_qkv.cu``) on
CUDA tensors and takes the plain twin ``ln_partition_qkv_reference`` on CPU
tensors; nothing falls back from the kernel to the twin.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from nerf_rpn_tpu_torch import kernels

EPS = 1e-5


def _geometry(x: torch.Tensor, window: Sequence[int], pad_size, shift):
    if x.dim() != 5:
        raise ValueError(f"x must be (B, X, Y, Z, C), got {tuple(x.shape)}")
    size = tuple(x.shape[1:4])
    pad_size = size if pad_size is None else tuple(int(p) for p in pad_size)
    shift = tuple(int(s) for s in shift)
    for s, p, w, sh in zip(size, pad_size, window, shift):
        if p < s or p % w or not 0 <= sh < p:
            raise ValueError(f"grid {size}, pad_size {pad_size}, window "
                             f"{tuple(window)}, shift {shift}: need pad_size >= "
                             "grid, divisible by the window, 0 <= shift < pad_size")
    return pad_size, shift


def ln_partition_qkv_reference(x, ln_scale, ln_bias, w, b, window,
                               pad_size=None, shift=(0, 0, 0)) -> torch.Tensor:
    """Plain PyTorch twin of kernel K5 (same arguments): LN, zero pad to
    ``pad_size``, roll by ``-shift``, window partition, f32 product + f32
    bias, one rounding.  Returns (B * nW, N, 3C) in x's dtype."""
    pad_size, shift = _geometry(x, window, pad_size, shift)
    dtype = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    h = (xf - mu) * torch.rsqrt(var + EPS)
    h = (h * ln_scale.float() + ln_bias.float()).to(dtype)
    pad = [p - s for p, s in zip(pad_size, x.shape[1:4])]
    if any(pad):
        h = F.pad(h, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
    if any(shift):
        h = torch.roll(h, tuple(-s for s in shift), dims=(1, 2, 3))
    bsz, c = x.shape[0], x.shape[-1]
    (px, py, pz), (wx, wy, wz) = pad_size, window
    h = h.reshape(bsz, px // wx, wx, py // wy, wy, pz // wz, wz, c)
    h = h.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wx * wy * wz, c)
    y = torch.matmul(h.float(), w.to(dtype).float()) + b.float()
    return y.to(dtype)


def ln_partition_qkv(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                     w: torch.Tensor, b: torch.Tensor, window: Sequence[int],
                     pad_size: Sequence[int] | None = None,
                     shift: Sequence[int] = (0, 0, 0)) -> torch.Tensor:
    """(B, X, Y, Z, C) x, (C,) LN scale and bias, (C, 3C) packed qkv weight,
    (3C,) bias -> (B * nW, N, 3C) in x's dtype, windows batch-major.

    ``pad_size`` (default: the grid) is the window-divisible size the grid is
    zero-padded to after the LayerNorm, ``shift`` the cyclic shift.  CPU
    tensors take the plain twin; CUDA tensors launch kernel K5 or raise.
    """
    if x.device.type == "cpu":
        return ln_partition_qkv_reference(x, ln_scale, ln_bias, w, b, window,
                                          pad_size, shift)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    pad_size, shift = _geometry(x, window, pad_size, shift)
    if x.dtype not in kernels.DTYPE_CODES:
        raise TypeError(f"K5 takes f32 or bf16, got {x.dtype}")
    bsz, sx, sy, sz, c = x.shape
    n = int(window[0] * window[1] * window[2])
    if c % 16 or n % 16:
        raise ValueError(f"K5 needs C and the window volume to be multiples of 16, "
                         f"got C={c}, window {tuple(window)}")
    if tuple(w.shape) != (c, 3 * c) or tuple(b.shape) != (3 * c,) or \
            tuple(ln_scale.shape) != (c,) or tuple(ln_bias.shape) != (c,):
        raise ValueError(f"w must be ({c}, {3 * c}), b ({3 * c},), LN params ({c},)")
    dev = x.device
    x = x.contiguous()
    w = w.to(device=dev, dtype=x.dtype).contiguous()
    b = b.to(device=dev, dtype=torch.float32).contiguous()
    s = ln_scale.to(device=dev, dtype=torch.float32).contiguous()
    t = ln_bias.to(device=dev, dtype=torch.float32).contiguous()
    n_win = bsz * (pad_size[0] // window[0]) * (pad_size[1] // window[1]) * \
        (pad_size[2] // window[2])
    out = torch.empty((n_win, n, 3 * c), dtype=x.dtype, device=dev)
    kernels.launch(
        "ln_partition_qkv",
        x.data_ptr(), s.data_ptr(), t.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), bsz, sx, sy, sz, c, *pad_size, *shift, *window,
        kernels.DTYPE_CODES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    return out
