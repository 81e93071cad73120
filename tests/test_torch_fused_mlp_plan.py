"""Torch port: the host plan and the arithmetic of kernel K6, on the CPU.

The kernel (``csrc/fused_mlp.cu``) runs only on the card; what can be
checked here is its grid and its numerics:

- the planner (``mlp_plan``) gives every (token tile, hidden slice) one
  block, column tiles and weight k-chunks that divide both passes, and a
  block that fits shared memory, at the Swin-S eval stages, at fewer
  tokens than a tile, at C = 1536 with 40 tokens, at C = 16 and at a
  hidden width of 64, in bf16 and f32; it takes the plan its rule rates
  cheapest;
- the two-pass, split-hidden algorithm (LN rounded to the type; fc1 summed
  in f32 over the plan's k-chunks, bias and GELU rounded per column tile;
  fc2 summed in f32 per slice, the slices' f32 partials added in slice
  order; the epilogue's roundings), emulated in plain torch in bf16 and as
  3xTF32 in f32, stays within the tolerances the card holds the kernel to
  against ``fused_mlp_block_reference``;
- the wrapper takes the weights as the model passes them
  (``Linear.weight.t()``) and as contiguous tensors alike.

The emulations are helpers of this file; the twin does not change.
"""

import math

import numpy as np
import pytest
import torch

from nerf_rpn_tpu_torch.ops.fused_mlp import (
    EPS,
    MAX_BLOCK_SMEM,
    SMS,
    WARP_TILES,
    Plan,
    _erf_as7126,
    fused_mlp_block,
    fused_mlp_block_reference,
    mlp_plan,
    plan_blocks,
    plan_cost,
    plan_resident,
    plan_smem_bytes,
)

# (T, C, Hd): the Swin-S eval stages at 208x208x144, fewer tokens than a
# tile, Swin-L's widest LayerNorm with few tokens, C = 16, Hd = 64
BENCH = [(97344, 96, 384), (12168, 192, 768), (1521, 384, 1536), (245, 768, 3072)]
SHAPES = BENCH + [(7, 96, 384), (40, 1536, 6144), (100, 16, 64), (300, 96, 64)]
DTYPES = [torch.float32, torch.bfloat16]


def block_work(block: int, plan: Plan, hd: int) -> tuple[int, int, int]:
    """(first token, first hidden column, hidden columns) of block
    ``block``, as ``fused_mlp_kernel`` maps ``blockIdx.x``."""
    hs = hd // plan.splits
    return block // plan.splits * plan.rows, block % plan.splits * hs, hs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,c,hd", SHAPES)
def test_plan_covers_each_tile_and_slice_once_within_budget(t, c, hd, dtype):
    plan = mlp_plan(t, c, hd, dtype)
    r, s, bn, bk = plan
    hs = hd // s
    # what the C entry point takes
    assert r in (16, 32, 64) and bk in (16, 32, 64) and bn % 16 == 0
    assert hd % s == 0 and c % bn == 0 and hs % bn == 0 and c % bk == 0 and hs % bk == 0
    assert r * bn % 512 == 0 and r * bn // 512 in WARP_TILES
    assert plan_smem_bytes(c, hd, plan, dtype) <= MAX_BLOCK_SMEM
    assert plan_resident(c, hd, plan, dtype) >= 1
    tiles = -(-t // r)
    seen = np.zeros((tiles, hd), np.uint8)
    for blk in range(plan_blocks(t, plan)):
        tok0, h0, width = block_work(blk, plan, hd)
        seen[tok0 // r, h0:h0 + width] += 1
    assert (seen == 1).all()
    # a token tile's slices are neighbours in the grid
    if s > 1:
        assert block_work(1, plan, hd)[0] == block_work(0, plan, hd)[0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,c,hd", BENCH)
def test_plan_is_the_cheapest_the_rule_knows(t, c, hd, dtype):
    plan = mlp_plan(t, c, hd, dtype)
    best = plan_cost(t, c, hd, dtype, plan)
    for r in (64, 32, 16):
        for bk in (64, 32, 16):
            for bn in range(16, c + 1, 16):
                if c % bk or c % bn or r * bn % 512 or r * bn // 512 not in WARP_TILES:
                    continue
                for s in range(1, hd // bn + 1):
                    p = Plan(r, s, bn, bk)
                    if hd % s or hd // s % bn or hd // s % bk or \
                            plan_smem_bytes(c, hd, p, dtype) > MAX_BLOCK_SMEM:
                        continue
                    assert plan_cost(t, c, hd, dtype, p) >= best


def test_plan_at_the_bench_stages():
    """bf16: one slice and 64-token tiles at stage 0 (1521 blocks, two an
    SM); the hidden width split so that the late stages fill the card."""
    got = [mlp_plan(t, c, hd, torch.bfloat16) for t, c, hd in BENCH]
    assert got == [Plan(64, 1, 96, 32), Plan(32, 2, 64, 64), Plan(32, 8, 64, 64),
                   Plan(32, 16, 192, 64)]
    assert [plan_blocks(t, p) for (t, _, _), p in zip(BENCH, got)] == [1521, 762, 384, 128]
    assert plan_resident(96, 384, got[0], torch.bfloat16) == 2
    assert plan_smem_bytes(96, 384, got[0], torch.bfloat16) == \
        (64 * 104 + 64 * 392 + 4 * 96 * 40) * 2
    # the late stages put at least one block on most SMs
    assert all(plan_blocks(t, p) >= SMS * 0.9 for (t, _, _), p in zip(BENCH[1:], got[1:]))


def test_plan_without_a_fit_raises():
    # C = 16 x 95 in f32: R = 64 does not fit, and no smaller R has a BN
    # that divides C at a width the kernel is built for
    with pytest.raises(ValueError, match="no plan"):
        mlp_plan(100, 1520, 4 * 1520, torch.float32)


def _inputs(t, c, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0.2, 1.2, (t, c)).astype(np.float32)).to(dtype)
    s = torch.from_numpy(rng.normal(1, 0.2, c).astype(np.float32))
    sb = torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32))
    fc1, fc2 = torch.nn.Linear(c, hd), torch.nn.Linear(hd, c)
    with torch.no_grad():
        fc1.weight.copy_(torch.from_numpy((rng.normal(0, 1, (hd, c)) * c ** -0.5)
                                          .astype(np.float32)))
        fc1.bias.copy_(torch.from_numpy(rng.normal(0, 0.3, hd).astype(np.float32)))
        fc2.weight.copy_(torch.from_numpy((rng.normal(0, 1, (c, hd)) * hd ** -0.5)
                                          .astype(np.float32)))
        fc2.bias.copy_(torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32)))
    return x, s, sb, fc1, fc2


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to tf32, to nearest with ties away from zero
    (``cvt.rna.tf32.f32``)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _chunked(a: torch.Tensor, w: torch.Tensor, bk: int, tf32: bool) -> torch.Tensor:
    """a @ w summed in f32 over k-chunks of bk in order (bf16 products
    exact in f32; f32 as 3xTF32: lo.hi + hi.lo + hi.hi)."""
    acc = torch.zeros(a.shape[0], w.shape[1])
    for k0 in range(0, a.shape[1], bk):
        ak, wk = a[:, k0:k0 + bk], w[k0:k0 + bk]
        if tf32:
            ah, wh = _tf32(ak), _tf32(wk)
            acc = acc + (_tf32(ak - ah) @ wh + ah @ _tf32(wk - wh) + ah @ wh)
        else:
            acc = acc + ak @ wk
    return acc


def kernel_emulation(x, s, sb, w1, b1, w2, b2, plan, tf32=False):
    """K6's arithmetic under ``plan``: LN (fast variance) rounded to T; per
    hidden slice, fc1 over the k-chunks, h = round(round(acc) + b1) and
    GELU rounded per BN-wide column tile, fc2 over the slice's k-chunks;
    the slices' f32 partials summed in slice order; o = round(round(acc) +
    b2), out = round(x + o)."""
    dtype = x.dtype
    r, n_split, bn, bk = plan
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    a = ((xf - mean) * torch.rsqrt(var + EPS) * s + sb).to(dtype).float()
    w1, w2 = w1.to(dtype).float(), w2.to(dtype).float()
    b1, b2 = b1.to(dtype).float(), b2.to(dtype).float()
    hd = w1.shape[1]
    hs = hd // n_split
    total = None
    for h0 in range(0, hd, hs):
        tiles = []
        for j0 in range(h0, h0 + hs, bn):
            acc = _chunked(a, w1[:, j0:j0 + bn], bk, tf32)
            h = (acc.to(dtype).float() + b1[j0:j0 + bn]).to(dtype).float()
            tiles.append((h * 0.5 * (1.0 + _erf_as7126(h / math.sqrt(2.0)))).to(dtype).float())
        part = _chunked(torch.cat(tiles, dim=1), w2[h0:h0 + hs], bk, tf32)
        total = part if total is None else total + part
    o = (total.to(dtype).float() + b2).to(dtype)
    return x + o


def row_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in bf16 ulps of the largest |want| of its row."""
    scale = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(2.0 ** -100)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return ((got.float() - want.float()).abs() / ulp).max().item()


def _args(x, s, sb, fc1, fc2):
    return (x, s, sb, fc1.weight.detach().t(), fc1.bias.detach(),
            fc2.weight.detach().t(), fc2.bias.detach())


# the planner's picks and forced splits: one slice, two, many
@pytest.mark.parametrize("t,c,hd,plan", [
    (77, 96, 384, None), (40, 192, 768, None), (130, 32, 128, Plan(64, 1, 32, 32)),
    (50, 64, 256, Plan(16, 4, 32, 16)), (33, 48, 192, Plan(32, 2, 48, 16))])
def test_bf16_emulation_holds_the_twin(t, c, hd, plan):
    x, s, sb, fc1, fc2 = _inputs(t, c, hd, torch.bfloat16, seed=t + c)
    args = _args(x, s, sb, fc1, fc2)
    plan = plan or mlp_plan(t, c, hd, torch.bfloat16)
    got = kernel_emulation(*args, plan)
    want = fused_mlp_block_reference(*args)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    assert row_ulps(got, want) <= 2.0


@pytest.mark.parametrize("t,c,hd,plan", [
    (77, 96, 384, None), (40, 192, 768, None), (50, 64, 256, Plan(16, 4, 32, 16))])
def test_3xtf32_emulation_holds_the_f32_twin(t, c, hd, plan):
    x, s, sb, fc1, fc2 = _inputs(t, c, hd, torch.float32, seed=t + c + 1)
    args = _args(x, s, sb, fc1, fc2)
    plan = plan or mlp_plan(t, c, hd, torch.float32)
    got = kernel_emulation(*args, plan, tf32=True)
    want = fused_mlp_block_reference(*args)
    assert (got - want).abs().max().item() <= 1e-5 * (1 + want.abs().max().item())
    # one tf32 product a pass alone would not hold 1e-5
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    a = (xf - mean) * torch.rsqrt(var + EPS) * s + sb
    h = _tf32(a) @ _tf32(args[3]) + args[4]
    h = h * 0.5 * (1.0 + _erf_as7126(h / math.sqrt(2.0)))
    one = x + (_tf32(h) @ _tf32(args[5]) + args[6])
    assert (one - want).abs().max().item() > 1e-5 * (1 + want.abs().max().item())


@pytest.mark.parametrize("dtype", DTYPES)
def test_weights_as_linear_views_or_contiguous(dtype):
    x, s, sb, fc1, fc2 = _inputs(45, 48, 192, dtype, seed=5)
    args = _args(x, s, sb, fc1, fc2)
    assert not args[3].is_contiguous() and not args[5].is_contiguous()
    got = fused_mlp_block(*args)
    want = fused_mlp_block(*args[:3], args[3].contiguous(), args[4], args[5].contiguous(),
                           args[6])
    assert torch.equal(got, want)
