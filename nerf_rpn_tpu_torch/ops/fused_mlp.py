"""The MLP half of a Swin block, ``x + fc2(GELU(fc1(LN(x))))``: kernel K6.

Port of ``fused_mlp_block`` (``nerf_rpn_tpu/ops/fused_mlp.py:83-132``) with
the rounding points of its TPU kernel ``_kernel``:

- LayerNorm with the fast variance ``E[x^2] - E[x]^2`` in f32, eps inside
  the square root, its affine in f32, rounded to x's dtype;
- ``h = round(LN(x) @ w1)`` (f32 accumulation), then ``h = h + b1`` in the
  dtype;
- GELU in f32 from that h, ``h * 0.5 * (1 + erf(h / sqrt 2))`` with the
  Abramowitz & Stegun 7.1.26 erf of ``_erf_f32``, rounded;
- ``o = round(h @ w2)``, ``o = o + b2`` in the dtype, ``x + o`` in the dtype.

This is not the model's train-mode chain (``ops.activations.erf_gelu``
rounds at other points).  ``fused_mlp_block`` launches the CUDA kernel
(``csrc/fused_mlp.cu``) on CUDA tensors and takes the plain twin
``fused_mlp_block_reference`` on CPU tensors; nothing falls back from the
kernel to the twin.
"""

from __future__ import annotations

import math

import torch

from nerf_rpn_tpu_torch import kernels

EPS = 1e-5


def _erf_as7126(x: torch.Tensor) -> torch.Tensor:
    """f32 erf of ``_erf_f32`` (A&S 7.1.26, |error| <= 1.5e-7)."""
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-a * a))


def _check(x, ln_scale, ln_bias, w1, b1, w2, b2) -> tuple[int, int, int]:
    if x.dim() != 2:
        raise ValueError(f"x must be (T, C), got {tuple(x.shape)}")
    t, c = x.shape
    hd = w1.shape[-1]
    want = {"ln_scale": (c,), "ln_bias": (c,), "w1": (c, hd), "b1": (hd,),
            "w2": (hd, c), "b2": (c,)}
    got = {"ln_scale": ln_scale, "ln_bias": ln_bias, "w1": w1, "b1": b1,
           "w2": w2, "b2": b2}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(got[name].shape)}")
    return t, c, hd


def hidden_splits(tokens: int, c: int, hd: int, sms: int) -> int:
    """Blocks per token tile over the hidden width for kernel K6: the
    largest divisor of ``hd / 64`` that keeps about two blocks per SM (the
    kernel's tiles are 32 tokens up to C = 768, 16 above)."""
    tiles = -(-tokens // (32 if c <= 768 else 16))
    chunks = hd // 64
    target = max(1, -(-2 * sms // tiles))
    return max(d for d in range(1, chunks + 1) if chunks % d == 0 and d <= target)


def fused_mlp_block_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                              eps: float = EPS) -> torch.Tensor:
    """Plain PyTorch twin of kernel K6 (same arguments and rounding)."""
    _check(x, ln_scale, ln_bias, w1, b1, w2, b2)
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = (y * ln_scale.float() + ln_bias.float()).to(dtype)
    h = torch.matmul(y.float(), w1.to(dtype).float()).to(dtype) + b1.to(dtype)
    hf = h.float()
    h = (hf * 0.5 * (1.0 + _erf_as7126(hf / math.sqrt(2.0)))).to(dtype)
    o = torch.matmul(h.float(), w2.to(dtype).float()).to(dtype) + b2.to(dtype)
    return x + o


def fused_mlp_block(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """(T, C) tokens, (C,) LN scale and bias, (C, Hd) w1, (Hd,) b1, (Hd, C)
    w2, (C,) b2 -> (T, C) in x's dtype.  The weights are cast to x's dtype
    once per call, as flax's Dense casts them.

    CPU tensors take the plain twin; CUDA tensors launch kernel K6 or raise.
    """
    if x.device.type == "cpu":
        return fused_mlp_block_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    t, c, hd = _check(x, ln_scale, ln_bias, w1, b1, w2, b2)
    if x.dtype not in kernels.DTYPE_CODES:
        raise TypeError(f"K6 takes f32 or bf16, got {x.dtype}")
    if c % 16 or c > 1536 or hd % 64:
        raise ValueError(f"K6 needs C a multiple of 16 up to 1536 and a hidden "
                         f"width that is a multiple of 64, got C={c}, {hd}")
    dev, dtype = x.device, x.dtype
    x = x.contiguous()
    s = ln_scale.to(device=dev, dtype=torch.float32).contiguous()
    sb = ln_bias.to(device=dev, dtype=torch.float32).contiguous()
    w1, b1, w2, b2 = (p.to(device=dev, dtype=dtype).contiguous() for p in (w1, b1, w2, b2))
    out = torch.empty_like(x)
    splits = hidden_splits(t, c, hd, torch.cuda.get_device_properties(dev).multi_processor_count)
    # f32 partial sums of each split, added in split order by the kernel
    part = torch.empty((splits, t, c), dtype=torch.float32, device=dev) if splits > 1 else None
    kernels.launch(
        "fused_mlp_block",
        x.data_ptr(), s.data_ptr(), sb.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, t, c, hd, splits,
        kernels.DTYPE_CODES[dtype], eps, torch.cuda.current_stream(dev).cuda_stream)
    return out
