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

The kernel runs one block per (R token rows, hidden slice of Hd / S
columns), block b taking slice ``b % S`` of token tile ``b // S``: fc1
into a shared hidden tile, then fc2 from it, both weights read in
nn.Linear's layout in (BN x BK) chunks through one ring; with S > 1 the
f32 partial sums of the slices are added in slice order by a second
kernel.  :func:`mlp_plan` picks (R, S, BN, BK).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from nerf_rpn_tpu_torch import kernels
from nerf_rpn_tpu_torch.ops.fused_ln_qkv import (
    K_CHUNKS,
    MAX_BLOCK_SMEM,
    MAX_C,
    MAX_RESIDENT,
    RING,
    ROWS,
    SMEM_PER_SM,
    W_CHUNK,
    W_KB,
    W_MMA,
    W_PASS,
    WARP_TILES,
)
from nerf_rpn_tpu_torch.ops.window_attention import SMS

EPS = 1e-5
HBM_BYTES_PER_US = 3.35e6   # an H100 SXM's device-memory rate


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


class Plan(NamedTuple):
    rows: int     # R: token rows a block
    splits: int   # S: hidden slices of Hd / S columns
    cols: int     # BN: column tile of either pass
    k_chunk: int  # BK: weight k-chunk


def plan_smem_bytes(c: int, hd: int, plan: Plan, dtype: torch.dtype) -> int:
    """Shared memory of a K6 block (``smem_bytes`` in the CUDA source): the
    (R, C) A tile, the (R, Hd / S) hidden tile and RING (BN, BK) weight
    chunks, each row padded by 16 bytes."""
    r, s, bn, bk = plan
    pad = 16 // dtype.itemsize
    return (r * (c + pad) + r * (hd // s + pad) + RING * bn * (bk + pad)) * dtype.itemsize


def plan_resident(c: int, hd: int, plan: Plan, dtype: torch.dtype) -> int:
    """K6 blocks an SM holds at once, by shared memory and registers."""
    return min(MAX_RESIDENT, SMEM_PER_SM // (plan_smem_bytes(c, hd, plan, dtype) + 1024))


def plan_blocks(tokens: int, plan: Plan) -> int:
    """Blocks of the K6 grid."""
    return -(-tokens // plan.rows) * plan.splits


def plan_cost(tokens: int, c: int, hd: int, dtype: torch.dtype, plan: Plan) -> float:
    """The rule's time of a plan (us): the serial chain of the busiest
    resident slot -- waves of blocks, each a LayerNorm pass per 8 rows a
    warp, its weight chunks and their products, priced at the step costs
    the same mainloop showed in K5 (``ops.fused_ln_qkv``'s W_PASS, W_CHUNK,
    W_MMA, W_KB: measured there, not refitted) -- plus the weight and x
    bytes an SM streams from L2, plus the f32 partial sums of S > 1, written
    and read back at the device-memory rate."""
    r, s, bn, bk = plan
    hs = hd // s
    rows = r // 4
    passes = -(-rows // min(rows, 8))
    chunks = 2 * hs * c // (bn * bk)
    steps = bk // 16 * (r * bn // 512) * (1 if dtype == torch.bfloat16 else 4)
    blocks = plan_blocks(tokens, plan)
    waves = -(-blocks // (SMS * plan_resident(c, hd, plan, dtype)))
    kb = blocks / SMS * (2 * hs + r) * c * dtype.itemsize / 1024
    partials = 2 * s * tokens * c * 4 if s > 1 else 0
    return (waves * (passes * W_PASS + chunks * (W_CHUNK + steps * W_MMA)) + kb * W_KB
            + partials / HBM_BYTES_PER_US)


@functools.lru_cache(maxsize=64)  # every eval block asks again
def mlp_plan(tokens: int, c: int, hd: int, dtype: torch.dtype) -> Plan:
    """(R, S, BN, BK) of the K6 grid for ``tokens`` rows of width C and a
    hidden width Hd.

    A plan takes R in ROWS, BK in K_CHUNKS and BN a multiple of 16 with
    ``R * BN / 512`` in WARP_TILES (the widths K5 is built for), BN and BK
    dividing both C and the slice Hd / S, and fits a block's shared memory;
    of those, the one :func:`plan_cost` rates cheapest, then the least
    partial traffic, the larger R, BK and BN.  Raises ValueError where no
    plan exists."""
    plans = [Plan(r, s, bn, bk) for r in ROWS for bk in K_CHUNKS if c % bk == 0
             for bn in range(16, c + 1, 16)
             if c % bn == 0 and r * bn % 512 == 0 and r * bn // 512 in WARP_TILES
             for s in range(1, hd // bn + 1)
             if hd % s == 0 and hd // s % bn == 0 and hd // s % bk == 0]
    plans = [p for p in plans if plan_smem_bytes(c, hd, p, dtype) <= MAX_BLOCK_SMEM]
    if not plans:
        raise ValueError(f"K6 has no plan for C={c}, Hd={hd} in {dtype}")
    return min(plans, key=lambda p: (plan_cost(tokens, c, hd, dtype, p), p.splits,
                                     -p.rows, -p.k_chunk, -p.cols))


def fused_mlp_block_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                              eps: float = EPS) -> torch.Tensor:
    """Plain PyTorch twin of kernel K6 (same arguments and rounding; f64
    throughout for f64 input, which the kernel does not take)."""
    _check(x, ln_scale, ln_bias, w1, b1, w2, b2)
    dtype = x.dtype
    acc = torch.promote_types(dtype, torch.float32)
    xf = x.to(acc)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = (y * ln_scale.to(acc) + ln_bias.to(acc)).to(dtype)
    h = torch.matmul(y.to(acc), w1.to(dtype).to(acc)).to(dtype) + b1.to(dtype)
    hf = h.to(acc)
    h = (hf * 0.5 * (1.0 + _erf_as7126(hf / math.sqrt(2.0)))).to(dtype)
    o = torch.matmul(h.to(acc), w2.to(dtype).to(acc)).to(dtype) + b2.to(dtype)
    return x + o


def fused_mlp_block(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """(T, C) tokens, (C,) LN scale and bias, (C, Hd) w1, (Hd,) b1, (Hd, C)
    w2, (C,) b2 -> (T, C) in x's dtype.  The weights are cast to x's dtype
    once per call, as flax's Dense casts them.

    CPU tensors take the plain twin; CUDA tensors launch kernel K6 or raise;
    no tokens (a slab of the space axis that holds none) launch nothing.
    The kernel reads ``w1.t()`` and ``w2.t()``, so weights passed as
    ``Linear.weight.t()`` (as the model passes them) are read where they
    lie, cast to x's dtype if needed, and never transposed.
    """
    if x.device.type == "cpu":
        return fused_mlp_block_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    t, c, hd = _check(x, ln_scale, ln_bias, w1, b1, w2, b2)
    if x.dtype not in kernels.DTYPE_CODES:
        raise TypeError(f"K6 takes f32 or bf16, got {x.dtype}")
    if c % 16 or c > MAX_C or hd % 64:
        raise ValueError(f"K6 needs C a multiple of 16 up to {MAX_C} and a hidden "
                         f"width that is a multiple of 64, got C={c}, Hd={hd}")
    if t == 0:
        return torch.empty_like(x)
    dev, dtype = x.device, x.dtype
    x = x.contiguous()
    s = ln_scale.to(device=dev, dtype=torch.float32).contiguous()
    sb = ln_bias.to(device=dev, dtype=torch.float32).contiguous()
    w1t = w1.t().to(device=dev, dtype=dtype).contiguous()  # (Hd, C)
    w2t = w2.t().to(device=dev, dtype=dtype).contiguous()  # (C, Hd)
    b1, b2 = (p.to(device=dev, dtype=dtype).contiguous() for p in (b1, b2))
    if any(v.data_ptr() % 16 for v in (x, s, sb, w1t, b1, w2t, b2)):
        raise ValueError("K6's 16-byte loads need x, the weights, the biases and "
                         "the LN params to start on 16-byte boundaries")
    out = torch.empty_like(x)
    plan = mlp_plan(t, c, hd, dtype)
    # f32 partial sums of each hidden slice, added in slice order by the kernel
    part = (torch.empty((plan.splits, t, c), dtype=torch.float32, device=dev)
            if plan.splits > 1 else None)
    kernels.launch(
        "fused_mlp_block",
        x.data_ptr(), s.data_ptr(), sb.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
        w2t.data_ptr(), b2.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, t, c, hd, *plan,
        kernels.DTYPE_CODES[dtype], eps, torch.cuda.current_stream(dev).cuda_stream)
    return out
