"""Torch port: the host plan and the arithmetic of kernel K5, on the CPU.

The kernel (``csrc/fused_ln_qkv.cu``) runs only on the card; what can be
checked here is its grid and its numerics:

- the planner (``ln_qkv_plan``) covers every (window, token, output column)
  exactly once and fits a block's shared memory, at the Swin-S eval
  stages, at two scenes a batch, with fewer windows than SMs and at C from
  16 to 1536; it takes the plan its cost model rates cheapest, and in bf16
  at the bench stages that plan keeps two blocks an SM and every SM busy;
- the bf16 form (LN rounded to bf16, bf16 products summed in f32 over the
  plan's weight k-chunks in order, the f32 bias, one rounding) and the f32
  form's 3xTF32 products, emulated in plain torch, stay within the
  tolerances the card holds the kernel to against
  ``ln_partition_qkv_reference``;
- the wrapper takes the weight as the model passes it
  (``Linear.weight.t()``) and as a contiguous (C, 3C) tensor alike.

The emulations are helpers of this file; the twin does not change.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerf_rpn_tpu_torch.models import swin
from nerf_rpn_tpu_torch.ops.fused_ln_qkv import (
    EPS,
    MAX_BLOCK_SMEM,
    SMS,
    W_CHUNK,
    W_KB,
    W_MMA,
    W_PASS,
    W_SM_LN,
    W_SM_MMA,
    W_SM_OUT,
    WARP_TILES,
    Plan,
    ln_partition_qkv,
    ln_partition_qkv_reference,
    ln_qkv_plan,
    plan_blocks,
    plan_cost,
    plan_resident,
    plan_smem_bytes,
    plan_terms,
)

WINDOW = (4, 4, 4)
# (windows, C): the Swin-S eval stages at 208x208x144 (one scene), the
# same at two scenes a batch, then widths from 16 to Swin-L's 1536 with
# fewer windows than SMs and with many
BENCH = [(1521, 96), (245, 192), (48, 384), (8, 768)]
SHAPES = (BENCH + [(2 * w, c) for w, c in BENCH]
          + [(w, c) for c in (16, 96, 192, 384, 768, 1536) for w in (1, 5, 100)]
          + [(300, 1536), (700, 16)])


def block_tiles(block: int, c: int, plan: Plan) -> tuple[int, int, list[int]]:
    """(window, first token, first column of each of its G tiles) of block
    ``block`` of a grid over 64-token windows, as
    ``ln_partition_qkv_kernel`` maps ``blockIdx.x``."""
    n_grp, parts = 3 * c // plan.cols // plan.group, 64 // plan.rows
    first = block % n_grp * plan.group * plan.cols
    return (block // n_grp // parts, (block // n_grp) % parts * plan.rows,
            [first + j * plan.cols for j in range(plan.group)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,c", SHAPES)
def test_plan_covers_the_output_once_within_budget(w, c, dtype):
    plan = ln_qkv_plan(w, c, dtype)
    r, bn, bk, g = plan
    # what the C entry point takes
    assert r in (16, 32, 64) and 64 % r == 0
    assert bn % 16 == 0 and 3 * c % bn == 0 and bk in (16, 32, 64) and c % bk == 0
    assert r * bn % 512 == 0 and r * bn // 512 in WARP_TILES and 3 * c // bn % g == 0
    assert plan_smem_bytes(c, plan, dtype) <= MAX_BLOCK_SMEM
    assert plan_resident(c, plan, dtype) >= 1
    blocks = plan_blocks(w, 64, c, plan)
    seen = np.zeros((w, 64, 3 * c), np.uint8)
    for blk in range(blocks):
        win, tok0, cols = block_tiles(blk, c, plan)
        for col0 in cols:
            seen[win, tok0:tok0 + r, col0:col0 + bn] += 1
    assert (seen == 1).all()
    # a window's column groups are neighbours in the grid
    if 3 * c // bn // g > 1:
        assert block_tiles(1, c, plan)[:2] == block_tiles(0, c, plan)[:2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,c", BENCH)
def test_plan_is_the_cheapest_the_model_knows(w, c, dtype):
    """Every plan the kernel takes costs at least as much in the model; in
    bf16 the pick keeps two blocks an SM and every SM busy."""
    plan = ln_qkv_plan(w, c, dtype)
    best = plan_cost(w, c, dtype, plan)
    for r in (64, 32, 16):
        for bk in (64, 32, 16):
            for bn in range(16, 3 * c + 1, 16):
                if c % bk or 3 * c % bn or r * bn % 512 or r * bn // 512 not in WARP_TILES:
                    continue
                for g in range(1, 3 * c // bn + 1):
                    p = Plan(r, bn, bk, g)
                    if 3 * c // bn % g == 0 and plan_smem_bytes(c, p, dtype) <= MAX_BLOCK_SMEM:
                        assert plan_cost(w, c, dtype, p) >= best
    if dtype == torch.bfloat16:
        assert plan_resident(c, plan, dtype) >= 2 and plan_blocks(w, 64, c, plan) >= SMS


def test_plan_at_the_bench_stages():
    """bf16: 64 tokens and all three column tiles of 96 a block at stage 0
    (1521 blocks, one LayerNorm a window); at stage 2, 64 tokens and three
    tiles of 96 in 64-deep weight chunks (192 blocks, two an SM)."""
    got = [ln_qkv_plan(w, c, torch.bfloat16) for w, c in BENCH]
    assert got == [Plan(64, 96, 32, 3), Plan(64, 48, 64, 6), Plan(64, 96, 64, 3),
                   Plan(32, 96, 64, 2)]
    assert plan_smem_bytes(96, got[0], torch.bfloat16) == (64 * 104 + 4 * 96 * 40) * 2
    assert plan_resident(384, got[2], torch.bfloat16) == 2


def test_plan_terms_and_weights_make_the_cost():
    plan = ln_qkv_plan(48, 384, torch.float32)
    terms = plan_terms(48, 384, torch.float32, plan)
    assert len(terms) == 7 and all(t >= 0 for t in terms)
    assert plan_cost(48, 384, torch.float32, plan) == pytest.approx(
        sum(w * t for w, t in zip((W_PASS, W_CHUNK, W_MMA, W_KB, W_SM_MMA, W_SM_LN, W_SM_OUT),
                                  terms)))


def test_plan_with_few_windows():
    # one window at C = 96: 18 blocks of 32 tokens and 32 columns
    assert ln_qkv_plan(1, 96, torch.bfloat16) == Plan(32, 32, 32, 1)
    # C = 16 x 95 in f32: R = 64 does not fit, and no smaller R has a BN
    # that divides 3C = 4560 at a width the kernel is built for
    with pytest.raises(ValueError, match="no plan"):
        ln_qkv_plan(8, 1520, torch.float32)


def _inputs(c, dtype, seed, size=(9, 8, 11), batch=2):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0.3, 1.5, (batch, *size, c)).astype(np.float32))
    s = torch.from_numpy(rng.normal(1, 0.2, c).astype(np.float32))
    t = torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32))
    lin = torch.nn.Linear(c, 3 * c)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy((rng.normal(0, 1, (3 * c, c)) * c ** -0.5)
                                          .astype(np.float32)))
        lin.bias.copy_(torch.from_numpy(rng.normal(0, 0.5, 3 * c).astype(np.float32)))
    return x.to(dtype), s, t, lin


def _ln_partition(x, s, t, pad_size, shift):
    """LN(x) rounded to x's dtype, zero-padded, rolled and partitioned:
    the kernel's A rows, (W, 64, C)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    h = ((xf - mu) * torch.rsqrt(var + EPS) * s + t).to(x.dtype)
    pad = [p - q for p, q in zip(pad_size, x.shape[1:4])]
    h = F.pad(h, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
    h = torch.roll(h, tuple(-q for q in shift), dims=(1, 2, 3))
    return swin.window_partition(h, WINDOW)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to tf32, to nearest with ties away from zero
    (``cvt.rna.tf32.f32``)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def kernel_emulation(x, s, t, w_nk, b, pad_size, shift, plan, tf32=False):
    """K5's arithmetic: LN rounded to T; the product summed in f32 over the
    plan's k-chunks in order (bf16 products exact in f32; f32 as 3xTF32:
    lo.hi + hi.lo + hi.hi); the f32 bias; one rounding to T."""
    a = _ln_partition(x, s, t, pad_size, shift).float()
    wk = w_nk.to(x.dtype).float().t()  # (C, 3C)
    acc = torch.zeros(a.shape[:2] + (wk.shape[1],))
    for k0 in range(0, a.shape[-1], plan.k_chunk):
        ak, bk = a[..., k0:k0 + plan.k_chunk], wk[k0:k0 + plan.k_chunk]
        if tf32:
            ah, bh = _tf32(ak), _tf32(bk)
            al, bl = _tf32(ak - ah), _tf32(bk - bh)
            acc = acc + (al @ bh + ah @ bl + ah @ bh)
        else:
            acc = acc + ak @ bk
    return (acc + b.float()).to(x.dtype)


def row_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in bf16 ulps of the largest |want| of its row."""
    scale = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(2.0 ** -100)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return ((got.float() - want.float()).abs() / ulp).max().item()


@pytest.mark.parametrize("c,shift", [(96, (2, 2, 2)), (192, (0, 0, 0)), (384, (2, 2, 2))])
def test_bf16_emulation_holds_the_twin(c, shift):
    x, s, t, lin = _inputs(c, torch.bfloat16, seed=c)
    pad_size = (12, 8, 12)
    w = lin.weight.detach()
    plan = ln_qkv_plan(8, c, torch.bfloat16)
    got = kernel_emulation(x, s, t, w, lin.bias.detach(), pad_size, shift, plan)
    want = ln_partition_qkv_reference(x, s, t, w.t(), lin.bias.detach(), WINDOW,
                                      pad_size, shift)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    assert row_ulps(got, want) <= 2.0


@pytest.mark.parametrize("c,shift", [(96, (2, 2, 2)), (384, (0, 0, 0))])
def test_3xtf32_emulation_holds_the_f32_twin(c, shift):
    x, s, t, lin = _inputs(c, torch.float32, seed=c + 1)
    pad_size = (12, 8, 12)
    w = lin.weight.detach()
    plan = ln_qkv_plan(8, c, torch.float32)
    got = kernel_emulation(x, s, t, w, lin.bias.detach(), pad_size, shift, plan, tf32=True)
    want = ln_partition_qkv_reference(x, s, t, w.t(), lin.bias.detach(), WINDOW,
                                      pad_size, shift)
    assert (got - want).abs().max().item() <= 1e-5 * (1 + want.abs().max().item())
    # one tf32 product alone would not hold 1e-5
    a = _ln_partition(x, s, t, pad_size, shift)
    one = _tf32(a) @ _tf32(w.t()) + lin.bias.detach()
    assert (one - want).abs().max().item() > 1e-5 * (1 + want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_as_linear_view_or_contiguous(dtype):
    x, s, t, lin = _inputs(48, dtype, seed=5)
    view = lin.weight.detach().t()
    assert not view.is_contiguous()
    args = (WINDOW, (12, 8, 12), (2, 2, 2))
    got = ln_partition_qkv(x, s, t, view, lin.bias.detach(), *args)
    want = ln_partition_qkv(x, s, t, view.contiguous(), lin.bias.detach(), *args)
    assert torch.equal(got, want)

