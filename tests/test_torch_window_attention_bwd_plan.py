"""Torch port: the host plan and the arithmetic of the K2 kernel, on the CPU.

The kernel (``csrc/window_attention_bwd.cu``) runs only on the card; what
can be checked here is its grid and its numerics:

- the planner (``backward_groups``, ``backward_windows``) covers every
  (window, head) exactly once at the Swin-S train stages and at the edges
  (H = 1, H = 48, W = 1), keeps a block within its shared memory, and
  gives at least two blocks per SM where the work allows;
- an emulation of the kernel's bf16 arithmetic (f32 products of the
  bf16-rounded operands at the twin's rounding points, P as ``e * (1 /
  sum)``, dq scaled after the product, dbias summed per window run and
  then over runs in order) holds the twin within the tolerances the card
  holds the kernel to;
- the f32 form's 3xTF32 products (each operand split into tf32 hi + lo,
  three products) for all five products hold the f32 twin within 1e-5 of
  the output's scale at stage-0 widths.

The emulations are helpers of this file; the twin does not change.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from nerf_rpn_tpu_torch.models.swin import shift_attn_mask
from nerf_rpn_tpu_torch.ops.window_attention import (
    BWD_MAX_RESIDENT,
    BWD_SMEM_PER_SM,
    SMS,
    backward_groups,
    backward_resident,
    backward_smem_bytes,
    backward_windows,
    window_attention_backward_reference,
)

MAX_BLOCK_SMEM = 232448  # dynamic shared memory a block may take on an H100

# (W, H, D): the Swin-S train stages at 160^3 batch 2, then the edges
STAGES = [(2000, 3, 32), (250, 6, 32), (54, 12, 32), (16, 24, 32),
          (300, 1, 32), (40, 48, 8), (1, 48, 8), (1, 3, 32), (7, 1, 64),
          (2000, 48, 64), (133, 3, 16)]


def block_work(block: int, num_heads: int, n_groups: int, w: int) -> tuple[int, range]:
    """(head, windows) of block ``block`` in the ``n_groups * H`` grid, as
    ``window_attention_bwd_kernel`` maps ``blockIdx.x``."""
    return block % num_heads, backward_windows(block // num_heads, n_groups, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,h,d", STAGES)
def test_backward_plan_covers_every_window_once(w, h, d, dtype):
    n_groups = backward_groups(w, h, d, dtype)
    assert 1 <= n_groups <= w
    blocks = n_groups * h
    seen = Counter()
    for b in range(blocks):
        head, windows = block_work(b, h, n_groups, w)
        assert len(windows) >= 1
        assert list(windows) == sorted(windows)  # walked in order
        seen.update((win, head) for win in windows)
    assert len(seen) == w * h and set(seen.values()) == {1}
    assert all(0 <= win < w and 0 <= head < h for win, head in seen)
    # runs differ by one window at most
    sizes = {len(backward_windows(r, n_groups, w)) for r in range(n_groups)}
    assert max(sizes) - min(sizes) <= 1
    # two blocks per SM where the work allows; about one wave of
    # resident blocks otherwise (the dbias partials stay small)
    assert blocks >= min(w * h, 2 * SMS)
    assert blocks <= max(SMS * backward_resident(d, dtype), -(-2 * SMS // h) * h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 32, 48, 64])
def test_backward_smem_fits_the_block_and_the_sm(d, dtype):
    smem = backward_smem_bytes(d, dtype)
    assert smem <= MAX_BLOCK_SMEM
    resident = backward_resident(d, dtype)
    assert 1 <= resident <= BWD_MAX_RESIDENT
    assert resident * (smem + 1024) <= BWD_SMEM_PER_SM


def test_backward_smem_at_the_train_shape():
    """bf16, D = 32: two buffers of four 64 x 40 tiles, two 64 x 72
    staged tiles and the f32 bias, three blocks an SM; f32 at D = 64 holds
    one."""
    assert backward_smem_bytes(32, torch.bfloat16) == (8 * 64 * 40 + 2 * 64 * 72) * 2 + 64 * 64 * 4
    assert backward_resident(32, torch.bfloat16) == 3
    assert backward_smem_bytes(64, torch.float32) == (8 * 64 * 68 + 2 * 64 * 72) * 4
    assert backward_resident(64, torch.float32) == 1
    got = [backward_groups(w, h, d, torch.bfloat16) * h for w, h, d in STAGES[:4]]
    assert got == [396, 396, 396, 384]


def _inputs(w, h, d, dtype, seed, mask_pad=None):
    rng = np.random.default_rng(seed)
    c = h * d
    qkv = torch.from_numpy(rng.normal(0, 1, (w, 64, 3 * c)).astype(np.float32)).to(dtype)
    dout = torch.from_numpy(rng.normal(0, 1, (w, 64, c)).astype(np.float32)).to(dtype)
    bias = torch.from_numpy(rng.normal(0, 0.5, (h, 64, 64)).astype(np.float32))
    mask = None
    if mask_pad is not None:
        mask = torch.from_numpy(shift_attn_mask(mask_pad, (4, 4, 4), (2, 2, 2)))
    return qkv, dout, bias, mask


def _heads(qkv, dout, h):
    w, n, c3 = qkv.shape
    d = c3 // 3 // h
    q, k, v = qkv.reshape(w, n, 3, h, d).permute(2, 0, 3, 1, 4)
    g = dout.reshape(w, n, h, d).transpose(1, 2)
    return q, k, v, g, d


def _logits(s, bias, mask, w):
    s = s + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(w // nw, nw, *s.shape[1:]) + mask[None, :, None]).reshape(s.shape)
    return s


def _softmax_rcp(s):
    """P as the kernel forms it: e * (1 / sum), f32."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e * (1.0 / e.sum(dim=-1, keepdim=True))


def _pack(dq, dk, dv):
    w, h, n, d = dq.shape
    return torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(w, n, 3 * h * d)


def _dbias_by_runs(ds, num_heads, d, dtype):
    """The kernel's dbias: each block sums its run's windows in order; the
    second kernel sums S slices of the runs (S = 1, 2, 4 or 8, 16 runs or
    more each) in run order, then adds the slice sums in order."""
    w = ds.shape[0]
    n_groups = backward_groups(w, num_heads, d, dtype)
    parts = []
    for r in range(n_groups):
        part = torch.zeros_like(ds[0])
        for i in backward_windows(r, n_groups, w):
            part = part + ds[i]
        parts.append(part)
    slices = 1
    while 2 * slices <= 8 and 2 * slices * 16 <= n_groups:
        slices *= 2
    total = None
    for y in range(slices):
        acc = torch.zeros_like(ds[0])
        for r in range(y * n_groups // slices, (y + 1) * n_groups // slices):
            acc = acc + parts[r]
        total = acc if total is None else total + acc
    return total


def k2_bf16_kernel_emulation(qkv, dout, bias, mask, num_heads):
    """K2's bf16 arithmetic: f32 products of bf16 operands at the twin's
    rounding points (qs, round(p) for dv, round(ds) for dq and dk), P from
    a reciprocal, dq scaled after the product, dbias by runs."""
    w = qkv.shape[0]
    q, k, v, g, d = _heads(qkv, dout, num_heads)
    bf = torch.bfloat16
    scale = d ** -0.5
    qs = (q.float() * torch.tensor(scale, dtype=bf).float()).to(bf).float()
    k, v, g = k.float(), v.float(), g.float()
    p = _softmax_rcp(_logits(qs @ k.transpose(-1, -2), bias, mask, w))
    dv = (p.to(bf).float().transpose(-1, -2) @ g).to(bf)
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsb = ds.to(bf).float()
    dq = ((dsb @ k) * scale).to(bf)
    dk = (dsb.transpose(-1, -2) @ qs).to(bf)
    return _pack(dq, dk, dv), _dbias_by_runs(ds, num_heads, d, bf)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to tf32 (10 stored mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from tf32 halves: lo.hi + hi.lo + hi.hi, each product exact."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def k2_f32_kernel_emulation(qkv, dout, bias, mask, num_heads):
    """K2's f32 form: all five products in 3xTF32, P from a reciprocal."""
    w = qkv.shape[0]
    q, k, v, g, d = _heads(qkv, dout, num_heads)
    scale = d ** -0.5
    qs = q * scale
    p = _softmax_rcp(_logits(_mm_3xtf32(qs, k.transpose(-1, -2)), bias, mask, w))
    dv = _mm_3xtf32(p.transpose(-1, -2), g)
    dp = _mm_3xtf32(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = _mm_3xtf32(ds, k) * scale
    dk = _mm_3xtf32(ds.transpose(-1, -2), qs)
    return _pack(dq, dk, dv), _dbias_by_runs(ds, num_heads, d, torch.float32)


def _bf16_limit(scale: float) -> float:
    """2 bf16 ulps of the output's scale: the card's rule for K2."""
    return 2.0 ** (np.floor(np.log2(scale)) - 6)


# (W, H, D, mask pad): stage-0 and stage-2 widths with the real shift mask
# (the pad's windows, batch 2), and a stage-0 slice without one
EMU_CASES = [(96, 3, 32, (16, 16, 12)), (54, 12, 32, (12, 12, 12)), (40, 3, 32, None)]


@pytest.mark.parametrize("w,h,d,pad", EMU_CASES)
def test_bf16_emulation_holds_the_twin(w, h, d, pad):
    qkv, dout, bias, mask = _inputs(w, h, d, torch.bfloat16, seed=w + h, mask_pad=pad)
    if mask is not None:
        assert w % mask.shape[0] == 0
    got_q, got_b = k2_bf16_kernel_emulation(qkv, dout, bias, mask, h)
    want_q, want_b = window_attention_backward_reference(qkv, dout, bias, mask, h)
    assert got_q.dtype == want_q.dtype == torch.bfloat16 and got_q.shape == want_q.shape
    scale = want_q.float().abs().max().item()
    assert (got_q.float() - want_q.float()).abs().max().item() <= _bf16_limit(scale)
    # dbias: the unrounded f32 ds summed by runs against one sum over W
    b_scale = want_b.abs().max().item()
    assert (got_b - want_b).abs().max().item() <= 2e-5 * (1 + b_scale)


@pytest.mark.parametrize("w,h,d,pad", EMU_CASES)
def test_3xtf32_f32_form_holds_the_k2_twin(w, h, d, pad):
    qkv, dout, bias, mask = _inputs(w, h, d, torch.float32, seed=2 * w + h, mask_pad=pad)
    got_q, got_b = k2_f32_kernel_emulation(qkv, dout, bias, mask, h)
    want_q, want_b = window_attention_backward_reference(qkv, dout, bias, mask, h)
    scale = want_q.abs().max().item()
    assert (got_q - want_q).abs().max().item() <= 1e-5 * (1 + scale)
    b_scale = want_b.abs().max().item()
    assert (got_b - want_b).abs().max().item() <= 2e-5 * (1 + b_scale)


def test_single_tf32_products_would_not_hold_f32():
    """The 3xTF32 split is needed: one tf32 product per operand pair misses
    the f32 tolerance at stage-0 widths."""
    qkv, dout, bias, _ = _inputs(16, 3, 32, torch.float32, seed=9)
    q, k, _, _, d = _heads(qkv, dout, 3)
    s1 = _tf32(q * d ** -0.5) @ _tf32(k).transpose(-1, -2)
    s3 = _mm_3xtf32(q * d ** -0.5, k.transpose(-1, -2))
    want = (q * d ** -0.5) @ k.transpose(-1, -2)
    scale = want.abs().max().item()
    assert (s3 - want).abs().max().item() <= 1e-5 * (1 + scale)
    assert (s1 - want).abs().max().item() > 1e-5 * (1 + scale)
