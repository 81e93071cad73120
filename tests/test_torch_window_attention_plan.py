"""Torch port: the host plan and the arithmetic of the K1/K4 kernel, on the CPU.

The kernel (``csrc/window_attention.cu``) runs only on the card; what can
be checked here is its grid and its numerics:

- the head-group planner covers every (window, head) exactly once, keeps
  its shared-memory budget and its two-blocks-per-SM rule, at the Swin-S
  eval and train stage shapes and at odd head counts;
- K4's bf16 form keeps P in f32 as ``hi + lo`` (``hi = bf16(P)``, ``lo =
  bf16(P - hi)``, two f32 products) and scales the f32 logits after the
  product; emulated in plain torch, both stay within the tolerances the
  card holds the kernel to against ``fused_window_attention_reference``;
- the f32 form's 3xTF32 products (each operand split into tf32 hi + lo,
  three products) stay within 1e-5 of the output's scale of the f32 twins.

The emulations are helpers of this file; the twins do not change.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from nerf_rpn_tpu_torch.models.swin import shift_attn_mask, shift_mask_patterns
from nerf_rpn_tpu_torch.ops.window_attention import (
    MAX_HEAD_GROUP,
    SMS,
    TILE_SMEM_BUDGET,
    fused_window_attention_reference,
    head_group,
    tile_bytes,
    window_attention_reference,
)

# (W, H, D): the Swin-S eval stages at 208x208x144, the train stages at
# 160^3 batch 2, then head counts that no larger group divides or that
# swin_l-like widths bring
STAGES = [(1521, 3, 32), (245, 6, 32), (48, 12, 32), (8, 24, 32),
          (2000, 3, 32), (250, 6, 32), (54, 12, 32), (16, 24, 32),
          (300, 1, 32), (300, 7, 32), (40, 48, 32), (300, 48, 8), (300, 7, 64)]


def block_heads(block: int, num_heads: int, group: int) -> tuple[int, range]:
    """(window, heads) of block ``block`` in the ``W * H / G`` grid, as
    ``window_attention_kernel`` maps ``blockIdx.x``."""
    per = num_heads // group
    first = (block % per) * group
    return block // per, range(first, first + group)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,h,d", STAGES)
def test_head_group_covers_the_grid_within_budget(w, h, d, dtype):
    g = head_group(w, h, d, dtype)
    per = tile_bytes(d, dtype)
    assert 1 <= g <= MAX_HEAD_GROUP and h % g == 0
    if g > 1:
        assert g * per <= TILE_SMEM_BUDGET and w * (h // g) >= 2 * SMS
    # the largest such G
    for larger in range(g + 1, min(h, MAX_HEAD_GROUP) + 1):
        assert (h % larger or larger * per > TILE_SMEM_BUDGET
                or w * (h // larger) < 2 * SMS)
    blocks = w * h // g
    seen = Counter()
    for b in range(blocks):
        win, heads = block_heads(b, h, g)
        assert len(heads) == g
        seen.update((win, head) for head in heads)
    assert len(seen) == w * h and set(seen.values()) == {1}
    assert all(0 <= win < w and 0 <= head < h for win, head in seen)


def test_head_group_at_the_bench_stages():
    """bf16, D = 32: stage 0 takes all three heads, stage 3 one."""
    got = [head_group(w, h, 32, torch.bfloat16) for w, h, _ in STAGES[:4]]
    assert got == [3, 3, 2, 1]
    assert tile_bytes(32, torch.bfloat16) == 3 * 64 * 40 * 2
    assert tile_bytes(8, torch.float32) == 3 * 64 * 20 * 4


def row_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in bf16 ulps of the largest |want| of its row,
    the rule the card holds the bf16 kernels to."""
    scale = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(2.0 ** -100)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return ((got.float() - want.float()).abs() / ulp).max().item()


def _softmax_rows(s: torch.Tensor) -> torch.Tensor:
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)


def _k4_inputs(dtype, seed=0, heads=3, d=32, pad=(16, 16, 12)):
    """Stage-0 widths (H = 3, D = 32) with the real shift table."""
    table, ids = shift_mask_patterns(pad, (4, 4, 4), (2, 2, 2))
    rng = np.random.default_rng(seed)
    w = len(ids)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (w, heads, 64, d)).astype(np.float32)).to(dtype)
               for _ in range(3))
    bias = torch.from_numpy(rng.normal(0, 0.5, (heads, 64, 64)).astype(np.float32))
    return q, k, v, bias, torch.from_numpy(table), torch.from_numpy(ids)


def k4_bf16_kernel_emulation(q, k, v, bias, table, ids, split=True):
    """K4's bf16 arithmetic, unrounded output: f32 logits of the bf16 q, k
    times the scale after the product, f32 softmax, and P either as
    ``hi + lo`` bf16 halves with two f32 products or (``split=False``) in
    f32."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + bias[None] + table[ids.long()][:, None]
    p = _softmax_rows(s)
    if not split:
        return torch.matmul(p, v.float())
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    return torch.matmul(lo, v.float()) + torch.matmul(hi, v.float())


def test_k4_hi_lo_split_holds_the_twin():
    q, k, v, bias, table, ids = _k4_inputs(torch.bfloat16)
    got = k4_bf16_kernel_emulation(q, k, v, bias, table, ids)
    want_bf16 = fused_window_attention_reference(q, k, v, bias, table, ids)
    assert row_ulps(got.to(torch.bfloat16), want_bf16) <= 2.0
    want = fused_window_attention_reference(q.float(), k.float(), v.float(), bias, table, ids)
    # P = hi + lo to ~2^-17 relative: the f32 outputs move by far less
    # than 2e-5 of their scale
    assert (got - want).abs().max().item() <= 2e-5 * (1 + want.abs().max().item())
    # rounding P to bf16 instead (K1's arithmetic) would not hold 2e-5
    hi_only = torch.matmul(
        _softmax_rows(torch.matmul(q.float(), k.float().transpose(-1, -2)) * 32 ** -0.5
                      + bias[None] + table[ids.long()][:, None]).to(torch.bfloat16).float(),
        v.float())
    assert (hi_only - want).abs().max().item() > 2e-5 * (1 + want.abs().max().item())


def test_k4_scale_after_the_product_is_f32_rounding():
    q, k, v, bias, table, ids = _k4_inputs(torch.bfloat16, seed=1)
    got = k4_bf16_kernel_emulation(q, k, v, bias, table, ids, split=False)
    want = fused_window_attention_reference(q.float(), k.float(), v.float(), bias, table, ids)
    # (q k) s against (q s) k: a logit of magnitude up to ~2^3 differs by
    # an f32 ulp or two of itself (~2^-20), which moves each probability,
    # and so the output, by that much relative to its row's scale
    scale = want.abs().amax(dim=-1, keepdim=True)
    assert ((got - want).abs() / scale).max().item() <= 2.0 ** -18
    assert row_ulps(got.to(torch.bfloat16),
                    fused_window_attention_reference(q, k, v, bias, table, ids)) <= 2.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to tf32 (10 stored mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from tf32 halves: lo.hi + hi.lo + hi.hi, each product exact."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def test_tf32_rounding_emulation():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11, -1.0 - 2.0 ** -11,
                      1.0 + 2.0 ** -12])
    assert _tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -1.0 - 2.0 ** -10, 1.0]


def test_3xtf32_f32_form_holds_the_k4_twin():
    q, k, v, bias, table, ids = _k4_inputs(torch.float32, seed=2)
    scale = q.shape[-1] ** -0.5
    s = _mm_3xtf32(q * scale, k.transpose(-1, -2)) + bias[None] + table[ids.long()][:, None]
    got = _mm_3xtf32(_softmax_rows(s), v)
    want = fused_window_attention_reference(q, k, v, bias, table, ids)
    assert (got - want).abs().max().item() <= 1e-5 * (1 + want.abs().max().item())


def test_3xtf32_f32_form_holds_the_k1_twin():
    """Stage-0 widths, the real shift mask (nW windows of one scene)."""
    mask = torch.from_numpy(shift_attn_mask((16, 16, 12), (4, 4, 4), (2, 2, 2)))
    w, h, d = mask.shape[0], 3, 32
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(0, 1, (w, 64, 3 * h * d)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.5, (h, 64, 64)).astype(np.float32))
    q, k, v = qkv.view(w, 64, 3, h, d).permute(2, 0, 3, 1, 4)
    s = _mm_3xtf32(q * d ** -0.5, k.transpose(-1, -2)) + bias[None] + mask[:, None]
    got = _mm_3xtf32(_softmax_rows(s), v).transpose(1, 2).reshape(w, 64, h * d)
    want = window_attention_reference(qkv, bias, mask, h)
    assert (got - want).abs().max().item() <= 1e-5 * (1 + want.abs().max().item())
