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

The kernel runs one block per (R tokens of one window, G tiles of BN of the
3C output columns), block b taking column group ``b % n_grp`` (tiles from
``(b % n_grp) * G``), token part ``(b // n_grp) % parts`` and window
``b // n_grp // parts``, and reads the weight in nn.Linear's ``(3C, C)``
layout in k-chunks of BK; :func:`ln_qkv_plan` picks (R, BN, BK, G).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from nerf_rpn_tpu_torch import kernels
from nerf_rpn_tpu_torch.ops.window_attention import SMS

EPS = 1e-5

# the K5 planner (csrc/fused_ln_qkv.cu)
SMEM_PER_SM = 233472        # an H100 SM's 228 KB of shared memory (1 KB more a block)
MAX_BLOCK_SMEM = 232448     # dynamic shared memory of one block
MAX_RESIDENT = 4            # blocks an SM holds by registers (__launch_bounds__)
MAX_C = 1536                # widest LayerNorm the kernel takes (Swin-L's last stage)
RING = 4                    # weight k-chunk buffers of a block
ROWS = (64, 32, 16)         # R: tokens of one window a block takes
K_CHUNKS = (64, 32, 16)     # BK: weight k-chunk
WARP_TILES = (2, 4, 6, 8, 12)  # n8 column tiles a warp holds (R * BN / 512), as built
# The cost model's weights (us), fitted by non-negative least squares on
# the relative error to the device times of ~250 plans at the four Swin-S
# eval stages, bf16 and f32, on an H100 (scripts/time_ln_qkv_plans.py
# times plans and prints such a fit).  A block's serial chain, per wave of
# resident blocks: a LayerNorm pass, a weight chunk (the block's sync, the
# copies, the wait) and a chunk's products per 16-deep step of an n8 tile
# (3xTF32 counts four); the KB of weight and x rows an SM streams from L2;
# and the work an SM's blocks share: products, LayerNorm elements and
# output elements (per 1024).
W_PASS, W_CHUNK, W_MMA, W_KB = 0.778, 0.231, 0.0102, 0.0150
W_SM_MMA, W_SM_LN, W_SM_OUT = 0.00996, 0.0914, 0.00983


class Plan(NamedTuple):
    rows: int     # R
    cols: int     # BN
    k_chunk: int  # BK
    group: int    # G: column tiles a block takes in turn


def plan_smem_bytes(c: int, plan: Plan, dtype: torch.dtype) -> int:
    """Shared memory of a K5 block (``smem_bytes`` in the CUDA source): the
    (R, C) A tile and RING (BN, BK) weight chunks, each row padded by 16
    bytes."""
    pad = 16 // dtype.itemsize
    return (plan.rows * (c + pad) + RING * plan.cols * (plan.k_chunk + pad)) * dtype.itemsize


def plan_resident(c: int, plan: Plan, dtype: torch.dtype) -> int:
    """K5 blocks an SM holds at once, by shared memory and registers."""
    return min(MAX_RESIDENT, SMEM_PER_SM // (plan_smem_bytes(c, plan, dtype) + 1024))


def plan_blocks(n_windows: int, n_tok: int, c: int, plan: Plan) -> int:
    """Blocks of the K5 grid."""
    return n_windows * (n_tok // plan.rows) * (3 * c // plan.cols // plan.group)


def plan_terms(n_windows: int, c: int, dtype: torch.dtype, plan: Plan,
               n_tok: int = 64) -> list[float]:
    """The cost model's terms of a plan, in the order of its weights
    (W_PASS, W_CHUNK, W_MMA, W_KB, W_SM_MMA, W_SM_LN, W_SM_OUT)."""
    r, bn, bk, g = plan
    rows = r // 4                     # a warp's rows
    passes = -(-rows // min(rows, 8))
    chunks = g * (c // bk)
    steps = bk // 16 * (r * bn // 512) * (1 if dtype == torch.bfloat16 else 4)
    blocks = plan_blocks(n_windows, n_tok, c, plan)
    waves = -(-blocks // (SMS * plan_resident(c, plan, dtype)))
    per_sm = blocks / SMS
    kb = per_sm * (g * bn + r) * c * dtype.itemsize / 1024
    return [waves * passes, waves * chunks, waves * chunks * steps, kb,
            per_sm * chunks * steps, per_sm * r * c / 1024, per_sm * g * r * bn / 1024]


def plan_cost(n_windows: int, c: int, dtype: torch.dtype, plan: Plan, n_tok: int = 64) -> float:
    """The cost model's estimate of a plan (us): the terms of
    :func:`plan_terms` times their weights."""
    weights = (W_PASS, W_CHUNK, W_MMA, W_KB, W_SM_MMA, W_SM_LN, W_SM_OUT)
    return sum(w * t for w, t in zip(weights, plan_terms(n_windows, c, dtype, plan, n_tok)))


@functools.lru_cache(maxsize=64)  # every eval block asks again; the search costs ~1 ms
def ln_qkv_plan(n_windows: int, c: int, dtype: torch.dtype, n_tok: int = 64) -> Plan:
    """(R, BN, BK, G) of the K5 grid for ``n_windows`` windows of
    ``n_tok`` tokens at width C.

    A plan takes R in ROWS dividing the window volume, BK in K_CHUNKS
    dividing C, BN a multiple of 16 dividing 3C with ``R * BN / 512`` in
    WARP_TILES, G dividing 3C / BN, and fits a block's shared memory; of
    those, the one :func:`plan_cost` rates cheapest, then the larger R and
    BK.  Raises ValueError where no plan exists."""
    plans = [Plan(r, bn, bk, g) for r in ROWS if n_tok % r == 0
             for bk in K_CHUNKS if c % bk == 0
             for bn in range(16, 3 * c + 1, 16)
             if 3 * c % bn == 0 and r * bn % 512 == 0 and r * bn // 512 in WARP_TILES
             for g in range(1, 3 * c // bn + 1) if 3 * c // bn % g == 0]
    plans = [p for p in plans if plan_smem_bytes(c, p, dtype) <= MAX_BLOCK_SMEM]
    if not plans:
        raise ValueError(f"K5 has no plan for C={c}, {n_tok} tokens a window in {dtype}")
    return min(plans, key=lambda p: (plan_cost(n_windows, c, dtype, p, n_tok),
                                     -p.rows, -p.k_chunk))


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
    The kernel reads ``w.t()``, so a weight passed as ``Linear.weight.t()``
    (as the model passes it) is read where it lies, cast to x's dtype if
    needed, and never transposed.
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
    if c % 16 or n % 16 or c > MAX_C:
        raise ValueError(f"K5 needs C and the window volume to be multiples of 16 "
                         f"and C <= {MAX_C}, got C={c}, window {tuple(window)}")
    if tuple(w.shape) != (c, 3 * c) or tuple(b.shape) != (3 * c,) or \
            tuple(ln_scale.shape) != (c,) or tuple(ln_bias.shape) != (c,):
        raise ValueError(f"w must be ({c}, {3 * c}), b ({3 * c},), LN params ({c},)")
    dev = x.device
    x = x.contiguous()
    wt = w.t().to(device=dev, dtype=x.dtype).contiguous()  # (3C, C)
    b = b.to(device=dev, dtype=torch.float32).contiguous()
    s = ln_scale.to(device=dev, dtype=torch.float32).contiguous()
    t = ln_bias.to(device=dev, dtype=torch.float32).contiguous()
    n_win = bsz * (pad_size[0] // window[0]) * (pad_size[1] // window[1]) * \
        (pad_size[2] // window[2])
    out = torch.empty((n_win, n, 3 * c), dtype=x.dtype, device=dev)
    if any(v.data_ptr() % 16 for v in (x, wt, b, s, t)):
        raise ValueError("K5's 16-byte loads need x, w, b and the LN params to "
                         "start on 16-byte boundaries")
    kernels.launch(
        "ln_partition_qkv",
        x.data_ptr(), s.data_ptr(), t.data_ptr(), wt.data_ptr(), b.data_ptr(),
        out.data_ptr(), bsz, sx, sy, sz, c, *pad_size, *shift, *window,
        *ln_qkv_plan(n_win, c, x.dtype, n), kernels.DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    return out
