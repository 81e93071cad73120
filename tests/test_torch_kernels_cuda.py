"""CUDA kernels K1 to K6 and the NMS resolve kernel (on K3's AABB graph and
on the plain-torch OBB graph) against their plain PyTorch twins, on the GPU.

Needs a CUDA device and nvcc (the kernels are built from
``nerf_rpn_tpu_torch/csrc`` on first use); skips otherwise.  The chip run::

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

(``--noconftest``: the repo's conftest imports jax, which a GPU machine
need not have).  ``chip_smoke.py`` runs the same checks at the bench shapes.
"""

import numpy as np
import pytest
import torch

from nerf_rpn_tpu_torch import kernels
from nerf_rpn_tpu_torch.models.swin import shift_attn_mask, shift_mask_patterns
from nerf_rpn_tpu_torch.ops.fused_ln_qkv import (
    XSlab,
    ln_partition_qkv,
    ln_partition_qkv_reference,
    rank_slab,
)
from nerf_rpn_tpu_torch.ops.fused_mlp import (
    Plan,
    fused_mlp_block,
    fused_mlp_block_reference,
    mlp_plan,
)
from nerf_rpn_tpu_torch.ops.nms import nms_mask, obb_suppression_graph, sort_problems
from nerf_rpn_tpu_torch.ops.nms_graph import (
    RESOLVE_MULTIPLE,
    aabb_suppression_graph,
    aabb_suppression_graph_reference,
    resolve_keep,
    resolve_keep_reference,
)
from nerf_rpn_tpu_torch.ops.window_attention import (
    WindowAttention,
    fused_window_attention,
    fused_window_attention_reference,
    window_attention,
    window_attention_backward,
    window_attention_backward_reference,
    window_attention_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _attn_inputs(w, h, c, dtype, n_w, device, seed=0):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(0, 1, (w, 64, 3 * c)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.5, (h, 64, 64)).astype(np.float32))
    mask = None
    if n_w:
        m = np.where(rng.random((n_w, 64, 64)) < 0.2, -100.0, 0.0)
        mask = torch.from_numpy(m.astype(np.float32)).to(device)
    return qkv.to(device, dtype), bias.to(device), mask


# f32: both sides accumulate in f32 in different orders -> 1e-5; bf16:
# the per-row 2-ulp rule of check_close (below), as for K4-K6
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def check_k1(out, ref, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, **F32_TOL)
    else:
        check_close(out, ref, dtype)


# the K1/K4 grid runs one block per (window, group of G heads); the cases
# reach the planner's edges (ops.window_attention.head_group)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,h,c,n_w", [
    (37, 3, 96, 0),     # stage-0 widths, no shift; W < 132: G = 1
    (37, 3, 96, 37),    # stage-0 widths, shift mask
    (48, 6, 192, 12),   # stage-1 widths, mask broadcast over 4 scenes
    (20, 3, 24, 5),     # D = 8
    (600, 3, 96, 100),  # stage-0 widths, G = 3 in bf16
    (300, 6, 192, 0),   # stage-1 widths, G = 3 in bf16
    (8, 24, 768, 0),    # stage 3 (W = 8): G = 1 at H = 24, D = 32
    (300, 7, 224, 0),   # H = 7: no larger G divides it
    (300, 4, 64, 50),   # D = 16
    (300, 2, 128, 0),   # D = 64
    (40, 48, 384, 0),   # H = 48, D = 8: G = 6 in bf16
    (1000, 3, 96, 0),   # FCOS eval at 160^3, stages 0-2 (stage 3 is W = 8 above)
    (125, 6, 192, 0),
    (27, 12, 384, 0),
    # the RCNN fine-tune at 200x200x136, batch 2: stage 0 of the train step
    # (unshifted and with a mask) and the eval's stages 1-3
    (3042, 3, 96, 0),
    (3042, 3, 96, 1521),
    (490, 6, 192, 0),
    (96, 12, 384, 0),
    (16, 24, 768, 0),
])
def test_window_attention_kernel_matches_twin(cuda, w, h, c, n_w, dtype):
    qkv, bias, mask = _attn_inputs(w, h, c, dtype, n_w, cuda)
    before = kernels.counts()["window_attention_fwd"]
    out = window_attention(qkv, bias, mask, h)
    torch.cuda.synchronize()
    assert kernels.counts()["window_attention_fwd"] == before + 1
    ref = window_attention_reference(qkv, bias, mask, h)
    assert out.dtype == dtype and out.shape == (w, 64, c)
    check_k1(out, ref, dtype)


def test_window_attention_kernel_swin_shift_mask(cuda):
    """The real Swin shift mask (-100 blocks) at a padded stage-1 grid."""
    mask = torch.from_numpy(shift_attn_mask((8, 8, 12), (4, 4, 4), (2, 2, 2))).to(cuda)
    qkv, bias, _ = _attn_inputs(mask.shape[0] * 2, 6, 192, torch.float32, 0, cuda)
    out = window_attention(qkv, bias, mask, 6)
    ref = window_attention_reference(qkv, bias, mask, 6)
    torch.testing.assert_close(out, ref, **F32_TOL)


def test_window_attention_kernel_rejects_bad_shapes(cuda):
    qkv, bias, _ = _attn_inputs(4, 3, 96, torch.float32, 0, cuda)
    with pytest.raises(ValueError):
        window_attention(qkv[:, :32], bias, None, 3)
    with pytest.raises(ValueError):
        window_attention(qkv, bias, torch.zeros(3, 64, 64, device=cuda), 3)
    with pytest.raises(TypeError):
        window_attention(qkv.half(), bias, None, 3)
    # D = 12 in bf16 is 24 bytes: no 16-byte copies
    with pytest.raises(ValueError, match="16 bytes"):
        window_attention(torch.zeros((4, 64, 108), device=cuda, dtype=torch.bfloat16),
                         bias, None, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,h,c,n_w", [
    (37, 3, 96, 0),     # stage-0 widths, no shift
    (48, 6, 192, 12),   # stage-1 widths, mask broadcast over 4 scenes
    (2000, 3, 96, 0),   # stage 0 at 160^3, batch 2: several windows per run
    (20, 3, 24, 5),     # D = 8
    # the K2 planner's edges (ops.window_attention.backward_groups)
    (1, 3, 96, 1),      # W = 1: one window, one block per head
    (401, 3, 96, 0),    # prime W: runs of 3 and 4 windows
    (300, 1, 32, 0),    # H = 1
    (40, 48, 384, 0),   # H = 48, D = 8
    (300, 4, 64, 50),   # D = 16
    (300, 2, 128, 0),   # D = 64
    (54, 12, 384, 27),  # stage 2 at 160^3, batch 2, with a 27-window mask
    # the RCNN fine-tune train step at 200x200x136, batch 2, stages 0-2
    (3042, 3, 96, 0),
    (3042, 3, 96, 1521),
    (490, 6, 192, 245),
    (96, 12, 384, 48),
])
def test_window_attention_backward_kernel_matches_twin(cuda, w, h, c, n_w, dtype):
    qkv, bias, mask = _attn_inputs(w, h, c, dtype, n_w, cuda)
    dout = torch.randn((w, 64, c), generator=torch.Generator(cuda).manual_seed(1),
                       device=cuda).to(dtype)
    before = kernels.counts()["window_attention_bwd"]
    dqkv, dbias = window_attention_backward(qkv, dout, bias, mask, h)
    torch.cuda.synchronize()
    assert kernels.counts()["window_attention_bwd"] == before + 1
    ref_q, ref_b = window_attention_backward_reference(qkv, dout, bias, mask, h)
    assert dqkv.dtype == dtype and dqkv.shape == qkv.shape
    assert dbias.dtype == torch.float32 and dbias.shape == (h, 64, 64)
    scale = ref_q.float().abs().max().item()
    # f32: products summed in other orders; bf16: a probability or ds
    # rounding to the neighbouring bf16 value moves an output by <= 2 ulps
    lim = 1e-5 * (1 + scale) if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(scale)) - 6)
    assert (dqkv.float() - ref_q.float()).abs().max().item() <= lim
    # dbias: f32 sums of the unrounded ds over windows in another order
    torch.testing.assert_close(dbias, ref_b, rtol=0,
                               atol=2e-5 * (1 + ref_b.abs().max().item()))
    # the fixed-order reduction: a second run gives the same bits
    again = window_attention_backward(qkv, dout, bias, mask, h)
    assert torch.equal(again[0], dqkv) and torch.equal(again[1], dbias)


def test_window_attention_backward_kernel_rejects_bad_shapes(cuda):
    qkv, bias, _ = _attn_inputs(4, 3, 96, torch.float32, 0, cuda)
    dout = torch.zeros((4, 64, 96), device=cuda)
    with pytest.raises(ValueError):
        window_attention_backward(qkv, dout[:, :, :48], bias, None, 3)
    with pytest.raises(ValueError):
        window_attention_backward(qkv, dout, bias, torch.zeros(3, 64, 64, device=cuda), 3)
    # D = 12 in bf16 is 24 bytes: no 16-byte copies
    with pytest.raises(ValueError, match="16 bytes"):
        window_attention_backward(torch.zeros((4, 64, 108), device=cuda, dtype=torch.bfloat16),
                                  torch.zeros((4, 64, 36), device=cuda, dtype=torch.bfloat16),
                                  bias, None, 3)


def test_window_attention_autograd_kernels_match_twin_autograd(cuda):
    """K1 forward + K2 backward against autograd through K1's twin (f32)."""
    mask = torch.from_numpy(shift_attn_mask((8, 8, 12), (4, 4, 4), (2, 2, 2))).to(cuda)
    qkv, bias, _ = _attn_inputs(mask.shape[0] * 2, 6, 192, torch.float32, 0, cuda)
    cot = torch.randn((qkv.shape[0], 64, 192), device=cuda)
    grads = []
    for fn in (WindowAttention.apply, window_attention_reference):
        q, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
        (fn(q, b, mask, 6) * cot).sum().backward()
        grads.append((q.grad, b.grad))
    for got, want in zip(*grads):
        # f32 products in other orders, 1e-5 of the gradient's scale
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * (1 + want.abs().max().item()))


def _nms_boxes(p, n, n_pad, seed=0):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 60, (p, n, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(2, 40, (p, n, 3))], -1)
    boxes[:, n - n_pad:] = 0.0  # zero-volume padding rows
    return torch.from_numpy(boxes.astype(np.float32))


@pytest.mark.parametrize("p,n,n_pad,thresh", [
    (4, 2560, 60, 0.3), (1, 64, 0, 0.5), (3, 512, 100, 0.1)])
def test_suppression_graph_kernel_bit_exact(cuda, p, n, n_pad, thresh):
    boxes = _nms_boxes(p, n, n_pad).to(cuda)
    out = aabb_suppression_graph(boxes, thresh)
    torch.cuda.synchronize()
    ref = aabb_suppression_graph_reference(boxes, thresh)
    assert out.dtype == torch.int32 and out.shape == (p, n, n // 32)
    assert torch.equal(out, ref)


def test_suppression_graph_kernel_rejects_bad_shapes(cuda):
    boxes = _nms_boxes(1, 64, 0).to(cuda)
    with pytest.raises(ValueError):
        aabb_suppression_graph(boxes[:, :40], 0.3)
    with pytest.raises(TypeError):
        aabb_suppression_graph(boxes.double(), 0.3)


def _graph_reference(boxes, thresh):
    """The twin one problem at a time (its (Np, Np, 3) temporaries are
    0.8 GB each at Np = 8192)."""
    return torch.cat([aabb_suppression_graph_reference(boxes[q:q + 1], thresh)
                      for q in range(boxes.shape[0])])


NMS_TILES = [(p, n, t) for p in (1, 4, 16) for n in (32, 64, 256, 2560, 8192)
             for t in (0.0, 0.3, 0.7)]


@pytest.mark.parametrize("p,n,thresh", NMS_TILES)
def test_suppression_graph_kernel_tiles_bit_exact(cuda, p, n, thresh):
    """K3's tiles (32 rows x 8 words): ragged edges, the diagonal, tiles
    wholly above it, zero-volume pads and a zero threshold."""
    boxes = _nms_boxes(p, n, n // 8, seed=n + p).to(cuda)
    out = aabb_suppression_graph(boxes, thresh)
    torch.cuda.synchronize()
    assert out.dtype == torch.int32 and out.shape == (p, n, n // 32)
    assert torch.equal(out, _graph_reference(boxes, thresh))


def _svalid(p, n, seed):
    gen = torch.Generator().manual_seed(seed)
    valid = torch.rand((p, n), generator=gen) > 0.2
    valid[:, n - n // 8:] = False  # the pads
    return valid


# the resolve kernel reads 16-byte quads of a row: Np a multiple of 128
NMS_RESOLVE = [(p, n, t) for p, n, t in NMS_TILES if n % RESOLVE_MULTIPLE == 0]


@pytest.mark.parametrize("p,n,thresh", NMS_RESOLVE)
def test_resolve_kernel_matches_sweep_twin(cuda, p, n, thresh):
    boxes = _nms_boxes(p, n, n // 8, seed=n + p).to(cuda)
    graph = aabb_suppression_graph(boxes, thresh)
    svalid = _svalid(p, n, n + p).to(cuda)
    alive = resolve_keep(graph, svalid)
    again = resolve_keep(graph, svalid)
    torch.cuda.synchronize()
    assert alive.dtype == torch.bool and alive.shape == (p, n)
    assert torch.equal(alive, again)
    assert torch.equal(alive, resolve_keep_reference(graph, svalid))


@pytest.mark.parametrize("n", [256, 2560])
def test_resolve_kernel_depth_n_chain_and_all_invalid(cuda, n):
    """Unit boxes along x, each overlapping only the next (IoU 1/3): greedy
    keeps every other one; the sweep twin needs ~n sweeps.  Problem 1 is
    the same chain with every box invalid."""
    x = 0.5 * torch.arange(n, dtype=torch.float32)
    boxes = torch.zeros((2, n, 6))
    boxes[:, :, 0], boxes[:, :, 3] = x, x + 1.0
    boxes[:, :, 4:6] = 1.0
    svalid = torch.ones((2, n), dtype=torch.bool)
    svalid[1] = False
    graph = aabb_suppression_graph(boxes.to(cuda), 0.3)
    alive = resolve_keep(graph, svalid.to(cuda))
    again = resolve_keep(graph, svalid.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(alive, again)
    assert torch.equal(alive[0].cpu(), torch.arange(n) % 2 == 0)
    assert not alive[1].any()
    assert torch.equal(alive, resolve_keep_reference(graph, svalid.to(cuda)))


def test_nms_mask_cuda_matches_cpu_at_the_bench_problem(cuda):
    """4 problems of 2500 candidates (one scene's levels), scores with ties,
    a fifth invalid: the kernels' keep-set equals the CPU path's."""
    rng = np.random.default_rng(12)
    lo = rng.uniform(0, 150, (4, 2500, 3))
    boxes = torch.from_numpy(np.concatenate([lo, lo + rng.uniform(4, 60, (4, 2500, 3))],
                                            -1).astype(np.float32))
    scores = torch.from_numpy((rng.integers(0, 200, (4, 2500)) / 200).astype(np.float32))
    valid = torch.from_numpy(rng.random((4, 2500)) > 0.2)
    before = kernels.counts()
    got = nms_mask(boxes.to(cuda), scores.to(cuda), valid.to(cuda), 0.3)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert after["aabb_suppression_graph"] - before["aabb_suppression_graph"] == 1
    assert after["nms_resolve"] - before["nms_resolve"] == 1
    want = nms_mask(boxes, scores, valid, 0.3)
    assert torch.equal(got.cpu(), want)
    assert 0 < int(want.sum()) < int(valid.sum())


def _obb_problem(p, n, seed):
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(0, 120, (p, n, 3)), rng.uniform(4, 40, (p, n, 3)),
                            rng.uniform(-np.pi / 2, np.pi / 2, (p, n, 1))], -1)
    scores = (rng.integers(0, 200, (p, n)) / 200).astype(np.float32)
    return (torch.from_numpy(boxes.astype(np.float32)), torch.from_numpy(scores),
            torch.from_numpy(rng.random((p, n)) > 0.2))


def test_resolve_kernel_on_an_obb_graph_matches_sweep_twin(cuda):
    """The OBB graph (plain torch on the card) fed to the resolve kernel:
    the keep-set equals the sweep loop's on the same graph, and nms_mask
    of the OBBs on the card equals the CPU path's; K3 does not run."""
    boxes, scores, valid = _obb_problem(4, 1000, 13)
    _, sboxes, svalid = sort_problems(boxes.to(cuda), scores.to(cuda), valid.to(cuda))
    graph = obb_suppression_graph(sboxes, 0.3)
    assert int((graph != 0).sum()) > 0
    before = kernels.counts()
    alive = resolve_keep(graph, svalid)
    torch.cuda.synchronize()
    assert kernels.counts()["nms_resolve"] - before["nms_resolve"] == 1
    assert torch.equal(alive, resolve_keep_reference(graph, svalid))
    before = kernels.counts()
    got = nms_mask(boxes.to(cuda), scores.to(cuda), valid.to(cuda), 0.3)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert after["aabb_suppression_graph"] == before["aabb_suppression_graph"]
    assert after["nms_resolve"] - before["nms_resolve"] == 1
    want = nms_mask(boxes, scores, valid, 0.3)
    assert torch.equal(got.cpu(), want)
    assert 0 < int(want.sum()) < int(valid.sum())


# FCOS's cross-level problem at 160^3: one scene of 2500 + 2500 + 1000 + 125
# candidates, padded to Np = 6144
FCOS_N = 6125


@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
def test_kernels_at_the_fcos_problem(cuda, rotated):
    """K3 (AABBs) and the resolve kernel at Np = 6144 against their twins,
    and the keep-set of nms_mask on the card against the CPU path's."""
    if rotated:
        boxes, scores, valid = _obb_problem(1, FCOS_N, 21)
    else:
        rng = np.random.default_rng(21)
        lo = rng.uniform(0, 150, (1, FCOS_N, 3))
        boxes = torch.from_numpy(np.concatenate(
            [lo, lo + rng.uniform(4, 60, (1, FCOS_N, 3))], -1).astype(np.float32))
        scores = torch.from_numpy((rng.integers(0, 500, (1, FCOS_N)) / 500).astype(np.float32))
        valid = torch.from_numpy(rng.random((1, FCOS_N)) > 0.1)
    _, sboxes, svalid = sort_problems(boxes.to(cuda), scores.to(cuda), valid.to(cuda))
    assert sboxes.shape[1] == 6144
    if rotated:
        graph = obb_suppression_graph(sboxes, 0.3)
    else:
        graph = aabb_suppression_graph(sboxes, 0.3)
        assert torch.equal(graph, aabb_suppression_graph_reference(sboxes, 0.3))
    assert int((graph != 0).sum()) > 0
    alive = resolve_keep(graph, svalid)
    torch.cuda.synchronize()
    assert torch.equal(alive, resolve_keep_reference(graph, svalid))
    got = nms_mask(boxes.to(cuda), scores.to(cuda), valid.to(cuda), 0.3)
    want = nms_mask(boxes, scores, valid, 0.3)
    assert torch.equal(got.cpu(), want)
    assert 0 < int(want.sum()) < int(valid.sum())


def test_resolve_kernel_rejects_bad_shapes_and_dtypes(cuda):
    graph = aabb_suppression_graph(_nms_boxes(2, 256, 0).to(cuda), 0.3)
    svalid = torch.ones((2, 256), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        resolve_keep(graph[:, :, :1], svalid)
    with pytest.raises(ValueError):
        resolve_keep(graph, svalid[:, :32])
    with pytest.raises(TypeError):
        resolve_keep(graph.long(), svalid)
    with pytest.raises(TypeError):
        resolve_keep(graph, svalid.int())
    unaligned = torch.zeros(graph.numel() + 1, dtype=torch.int32, device=cuda)[1:]
    with pytest.raises(ValueError):  # contiguous, one word off 16-byte alignment
        resolve_keep(unaligned.view(graph.shape).copy_(graph), svalid)
    for n in (32, 64):  # rows not whole 16-byte quads
        small = aabb_suppression_graph(_nms_boxes(2, n, 0).to(cuda), 0.3)
        with pytest.raises(ValueError):
            resolve_keep(small, svalid[:, :n])


def row_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in bf16 ulps of the largest |want| of its row
    (last axis): a neighbouring-value rounding of an intermediate moves an
    output by a share of its row's scale, not of its own magnitude, where
    the row's terms cancel."""
    scale = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(2.0 ** -100)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return ((got.float() - want.float()).abs() / ulp).max().item()


def check_close(got, want, dtype):
    """f32: 1e-5 of the output's scale (f32 sums in other orders); bf16:
    2 ulps of each row's scale (the same rounding points, f32 sums in other
    orders)."""
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * (1 + want.abs().max().item()))
    else:
        assert row_ulps(got, want) <= 2.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad,b,h,d", [((8, 8, 12), 2, 3, 32),    # stage-0 heads
                                       ((16, 16, 12), 1, 12, 32),  # stage 2
                                       ((8, 8, 8), 1, 4, 8),       # D = 8
                                       ((52, 52, 36), 1, 3, 32),   # stage 0: G = 3 in bf16
                                       ((8, 8, 8), 1, 24, 32),     # stage 3: G = 1, H = 24
                                       ((24, 24, 20), 1, 7, 32),   # H = 7
                                       ((24, 24, 20), 1, 4, 16),   # D = 16
                                       ((24, 24, 20), 1, 2, 64),   # D = 64
                                       # FCOS eval at 160^3, stages 0-2
                                       ((40, 40, 40), 1, 3, 32),
                                       ((20, 20, 20), 1, 6, 32),
                                       ((12, 12, 12), 1, 12, 32),
                                       # RCNN fine-tune eval, batch 2
                                       ((52, 52, 36), 2, 3, 32),
                                       ((28, 28, 20), 2, 6, 32),
                                       ((16, 16, 12), 2, 12, 32),
                                       ((8, 8, 8), 2, 24, 32)])
def test_fused_window_attention_kernel_matches_twin(cuda, pad, b, h, d, dtype):
    table, ids = shift_mask_patterns(pad, (4, 4, 4), (2, 2, 2))
    table = torch.from_numpy(table).to(cuda)
    ids = torch.from_numpy(np.tile(ids, b)).to(cuda)
    w = ids.shape[0]
    gen = torch.Generator(cuda).manual_seed(5)
    qkv = torch.randn((w, 64, 3 * h * d), generator=gen, device=cuda).to(dtype)
    bias = 0.5 * torch.randn((h, 64, 64), generator=gen, device=cuda)
    # strided views of a packed qkv, as the eval route passes them
    q, k, v = qkv.view(w, 64, 3, h, d).permute(2, 0, 3, 1, 4)
    before = kernels.counts()["fused_window_attention"]
    out = fused_window_attention(q, k, v, bias, table, ids)
    torch.cuda.synchronize()
    assert kernels.counts()["fused_window_attention"] == before + 1
    ref = fused_window_attention_reference(q, k, v, bias, table, ids)
    check_close(out, ref, dtype)


def test_fused_window_attention_kernel_rejects_unaligned_views(cuda):
    table, ids = shift_mask_patterns((8, 8, 8), (4, 4, 4), (2, 2, 2))
    table, ids = torch.from_numpy(table).to(cuda), torch.from_numpy(ids).to(cuda)
    bias = torch.zeros((2, 64, 64), device=cuda)
    # rows 3 * 2 * 32 + 4 bf16 apart: 8-byte steps, no 16-byte copies
    qkv = torch.zeros((8, 64, 196), device=cuda, dtype=torch.bfloat16)[..., :192]
    q, k, v = qkv.view(8, 64, 3, 2, 32).permute(2, 0, 3, 1, 4)
    with pytest.raises(ValueError, match="16-byte"):
        fused_window_attention(q, k, v, bias, table, ids)
    strided_d = torch.zeros((8, 2, 32, 64), device=cuda, dtype=torch.bfloat16).transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous last axis"):
        fused_window_attention(strided_d, k, v, bias, table, ids)


def _ln_qkv_inputs(c, dtype, device, seed=6):
    gen = torch.Generator(device).manual_seed(seed)
    s = 1 + 0.2 * torch.randn(c, generator=gen, device=device)
    t = 0.2 * torch.randn(c, generator=gen, device=device)
    w = torch.randn((c, 3 * c), generator=gen, device=device) * c ** -0.5
    b = 0.5 * torch.randn(3 * c, generator=gen, device=device)
    return s, t, w.to(dtype), b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size,c,shift", [((12, 12, 8), 96, (0, 0, 0)),
                                          ((13, 13, 9), 192, (2, 2, 2)),  # padded
                                          ((7, 7, 5), 768, (2, 2, 2))])   # stage 3
def test_ln_partition_qkv_kernel_matches_twin(cuda, size, c, shift, dtype):
    x = torch.randn((2, *size, c), generator=torch.Generator(cuda).manual_seed(7),
                    device=cuda).to(dtype)
    params = _ln_qkv_inputs(c, dtype, cuda)
    pad = tuple(-(-s // 4) * 4 for s in size)
    before = kernels.counts()["ln_partition_qkv"]
    out = ln_partition_qkv(x, *params, (4, 4, 4), pad, shift)
    torch.cuda.synchronize()
    assert kernels.counts()["ln_partition_qkv"] == before + 1
    check_close(out, ln_partition_qkv_reference(x, *params, (4, 4, 4), pad, shift), dtype)


def _linear_weight_view(c, dtype, device, seed=9):
    """A (C, 3C) qkv weight as the model passes it: ``Linear.weight.t()``."""
    gen = torch.Generator(device).manual_seed(seed)
    w = torch.randn((3 * c, c), generator=gen, device=device) * c ** -0.5
    return w.to(dtype).t()


# the K5 grid runs one block per (R tokens of a window, G tiles of BN output
# columns) with weight k-chunks of BK; the cases reach the planner's edges
# (ops.fused_ln_qkv.ln_qkv_plan)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,size,c,shift", [
    (1, (8, 8, 8), 16, (0, 0, 0)),       # C = 16: 3C = 48, BK = 16, 8 windows
    (1, (4, 4, 8), 1536, (0, 0, 0)),     # C = 1536: R < 64, one block an SM
    (2, (9, 8, 11), 96, (2, 2, 2)),      # B = 2, pad and shift, 3C = 288
    (2, (9, 8, 11), 192, (2, 0, 2)),     # 3C = 576
    (1, (7, 7, 5), 768, (2, 2, 2)),      # stage 3: 8 windows
    (1, (13, 13, 9), 384, (2, 2, 2)),    # stage 2: 48 windows, G = 3 (bf16), 9 (f32)
    (1, (40, 40, 40), 96, (2, 2, 2)),    # FCOS eval at 160^3, stages 0-3
    (1, (20, 20, 20), 192, (2, 2, 2)),
    (1, (10, 10, 10), 384, (2, 2, 2)),
    (1, (5, 5, 5), 768, (2, 2, 2)),
    # the RCNN fine-tune eval at 200x200x136: batches of 2 and one scene
    *[(b, size, c, (2, 2, 2)) for b in (2, 1)
      for size, c in (((50, 50, 34), 96), ((25, 25, 17), 192), ((13, 13, 9), 384),
                      ((7, 7, 5), 768))],
])
def test_ln_partition_qkv_kernel_at_the_planner_edges(cuda, b, size, c, shift, dtype):
    x = torch.randn((b, *size, c), generator=torch.Generator(cuda).manual_seed(10),
                    device=cuda).to(dtype)
    s, t, _, bias = _ln_qkv_inputs(c, dtype, cuda)
    w = _linear_weight_view(c, dtype, cuda)
    pad = tuple(-(-q // 4) * 4 for q in size)
    before = kernels.counts()["ln_partition_qkv"]
    out = ln_partition_qkv(x, s, t, w, bias, (4, 4, 4), pad, shift)
    torch.cuda.synchronize()
    assert kernels.counts()["ln_partition_qkv"] == before + 1
    check_close(out, ln_partition_qkv_reference(x, s, t, w, bias, (4, 4, 4), pad, shift),
                dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_partition_qkv_weight_view_matches_contiguous(cuda, dtype):
    x = torch.randn((1, 9, 8, 11, 96), generator=torch.Generator(cuda).manual_seed(11),
                    device=cuda).to(dtype)
    s, t, _, bias = _ln_qkv_inputs(96, dtype, cuda)
    w = _linear_weight_view(96, dtype, cuda)
    args = ((4, 4, 4), (12, 8, 12), (2, 2, 2))
    assert torch.equal(ln_partition_qkv(x, s, t, w, bias, *args),
                       ln_partition_qkv(x, s, t, w.contiguous(), bias, *args))


# K5's slab form (the space axis): each rank's window columns of a space
# group of 2 or 3, shifted (the last rank's slab holds the global pad rows
# between real rows and the wrapped rows; their NaN contents must never be
# read) and not; the kernel against its twin and against the whole-grid
# kernel's windows
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size,c,n_space", [((13, 13, 9), 384, 2),   # the bench's stage 2
                                            ((52, 52, 36), 96, 2),   # stage 0
                                            ((17, 8, 6), 96, 3)])
@pytest.mark.parametrize("shift", [(0, 0, 0), (2, 2, 2)])
def test_ln_partition_qkv_kernel_slab_matches_twin(cuda, size, c, n_space, shift, dtype):
    from nerf_rpn_tpu_torch.parallel.space import window_bounds

    x = torch.randn((1, *size, c), generator=torch.Generator(cuda).manual_seed(12),
                    device=cuda).to(dtype)
    s, t, _, bias = _ln_qkv_inputs(c, dtype, cuda)
    w = _linear_weight_view(c, dtype, cuda)
    pad = tuple(-(-q // 4) * 4 for q in size)
    whole = ln_partition_qkv(x, s, t, w, bias, (4, 4, 4), pad, shift)
    full = XSlab(0, size[0], 0, pad[0] // 4)
    assert torch.equal(ln_partition_qkv(x, s, t, w, bias, (4, 4, 4), pad, shift, full), whole)
    n_yz = (pad[1] // 4) * (pad[2] // 4)
    for cols in window_bounds(size[0], 4, n_space)[1]:
        xs, slab = rank_slab(x, (4, 4, 4), pad, shift, cols)
        before = kernels.counts()["ln_partition_qkv"]
        got = ln_partition_qkv(xs, s, t, w, bias, (4, 4, 4), pad, shift, slab)
        torch.cuda.synchronize()
        assert kernels.counts()["ln_partition_qkv"] == before + (cols[1] > cols[0])
        check_close(got, ln_partition_qkv_reference(xs, s, t, w, bias, (4, 4, 4), pad, shift,
                                                    slab), dtype)
        mine = whole.view(pad[0] // 4, n_yz, *whole.shape[1:])[cols[0]:cols[1]]
        check_close(got, mine.reshape(got.shape), dtype)


def test_ln_partition_qkv_entry_rejects_plans_it_does_not_take(cuda):
    c = 160
    x = torch.zeros((1, 4, 4, 4, c), device=cuda)
    w = torch.zeros((3 * c, c), device=cuda)
    b = torch.zeros(3 * c, device=cuda)
    s, out = torch.ones(c, device=cuda), torch.empty((1, 64, 3 * c), device=cuda)

    def launch(rows, cols, k_chunk, group):
        kernels.launch("ln_partition_qkv", x.data_ptr(), s.data_ptr(), s.data_ptr(),
                       w.data_ptr(), b.data_ptr(), out.data_ptr(), 1, 4, 4, 4, c,
                       4, 4, 4, 0, 0, 0, 4, 4, 4, 0, 4, 0, 1, rows, cols, k_chunk, group,
                       kernels.DTYPE_CODES[torch.float32],
                       torch.cuda.current_stream(cuda).cuda_stream)

    launch(64, 96, 32, 5)  # a plan it takes: all five tiles of 96 in one block
    torch.cuda.synchronize()
    for plan in [(48, 96, 32, 1),   # R not in {16, 32, 64}
                 (64, 100, 32, 1),  # BN not a multiple of 16
                 (64, 80, 32, 1),   # 8 x 10 column tiles a warp: not built
                 (64, 96, 64, 1),   # BK does not divide C = 160
                 (64, 96, 48, 1),   # BK not in {16, 32, 64}
                 (64, 96, 32, 2),   # G does not divide the 5 tiles
                 (64, 96, 32, 0)]:
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch(*plan)
    wide = torch.zeros((1, 4, 4, 4, 1552), device=cuda)
    with pytest.raises(ValueError, match="C <= 1536"):
        ln_partition_qkv(wide, torch.ones(1552, device=cuda), torch.zeros(1552, device=cuda),
                         torch.zeros((1552, 3 * 1552), device=cuda),
                         torch.zeros(3 * 1552, device=cuda), (4, 4, 4))


def _mlp_inputs(t, c, dtype, device, seed=8, hd=None):
    """K6's arguments, the weights as the model passes them:
    ``Linear.weight.t()`` views in the compute dtype."""
    gen = torch.Generator(device).manual_seed(seed)
    hd = hd or 4 * c
    x = torch.randn((t, c), generator=gen, device=device).to(dtype)
    return (x, 1 + 0.2 * torch.randn(c, generator=gen, device=device),
            0.2 * torch.randn(c, generator=gen, device=device),
            (torch.randn((hd, c), generator=gen, device=device) * c ** -0.5).to(dtype).t(),
            (0.3 * torch.randn(hd, generator=gen, device=device)).to(dtype),
            (torch.randn((c, hd), generator=gen, device=device) * hd ** -0.5).to(dtype).t(),
            (0.3 * torch.randn(c, generator=gen, device=device)).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,c", [(20000, 96), (1000, 96), (301, 384), (245, 768),
                                 (40, 1536),
                                 # FCOS eval at 160^3, stages 0-3
                                 (64000, 96), (8000, 192), (1000, 384), (125, 768),
                                 # RCNN fine-tune eval at 200x200x136, batch 2 and 1
                                 (170000, 96), (21250, 192), (3042, 384), (490, 768),
                                 (85000, 96), (10625, 192), (1521, 384)])
def test_fused_mlp_kernel_matches_twin(cuda, t, c, dtype):
    args = _mlp_inputs(t, c, dtype, cuda)
    before = kernels.counts()["fused_mlp_block"]
    out = fused_mlp_block(*args)
    torch.cuda.synchronize()
    assert kernels.counts()["fused_mlp_block"] == before + 1
    check_close(out, fused_mlp_block_reference(*args), dtype)


# the K6 grid runs one block per (R token rows, hidden slice); the cases
# reach the planner's edges (ops.fused_mlp.mlp_plan): T not a multiple of
# R, one token, S > 1 at each Swin width, Hd = 2C and Hd = 64
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,c,hd", [
    (77, 96, 384), (1, 96, 384), (40, 96, 384), (40, 192, 768), (40, 384, 1536),
    (40, 768, 3072), (40, 1536, 6144), (300, 96, 192), (300, 192, 64),
    (12168, 192, 768), (1521, 384, 1536)])
def test_fused_mlp_kernel_at_the_planner_edges(cuda, t, c, hd, dtype):
    args = _mlp_inputs(t, c, dtype, cuda, seed=t + c, hd=hd)
    out = fused_mlp_block(*args)
    torch.cuda.synchronize()
    check_close(out, fused_mlp_block_reference(*args), dtype)


def _launch_mlp(args, plan):
    """K6's C entry under a given plan, with the wrapper's arguments."""
    x, s, sb, w1, b1, w2, b2 = args
    t, c = x.shape
    hd = w1.shape[1]
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    out = torch.empty_like(x)
    part = torch.empty((max(plan[1], 1), t, c), dtype=torch.float32, device=x.device)
    kernels.launch("fused_mlp_block", x.data_ptr(), s.data_ptr(), sb.data_ptr(),
                   w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
                   out.data_ptr(), part.data_ptr(), t, c, hd, *plan,
                   kernels.DTYPE_CODES[x.dtype], 1e-5,
                   torch.cuda.current_stream(x.device).cuda_stream)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hd,plan", [(96, 576, Plan(64, 1, 16, 16)),
                                       (96, 576, Plan(64, 2, 32, 32)),
                                       (96, 576, Plan(64, 3, 48, 32)),
                                       (192, 768, Plan(64, 4, 64, 64)),
                                       (96, 576, Plan(64, 2, 96, 32)),
                                       (192, 768, Plan(16, 6, 64, 64))])
def test_fused_mlp_entry_under_each_warp_tile(cuda, c, hd, plan, dtype):
    """Plans the planner may not pick, reaching each n8 tile count a warp
    holds (R * BN / 512 = 2, 4, 6, 8, 12)."""
    args = _mlp_inputs(150, c, dtype, cuda, seed=3, hd=hd)
    out = _launch_mlp(args, plan)
    torch.cuda.synchronize()
    check_close(out, fused_mlp_block_reference(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_weight_views_match_contiguous(cuda, dtype):
    args = _mlp_inputs(333, 192, dtype, cuda, seed=4)
    assert not args[3].is_contiguous() and not args[5].is_contiguous()
    got = fused_mlp_block(*args)
    want = fused_mlp_block(*args[:3], args[3].contiguous(), args[4], args[5].contiguous(),
                           args[6])
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_split_sums_are_bit_identical_between_runs(cuda, dtype):
    args = _mlp_inputs(1521, 384, dtype, cuda, seed=6)
    assert mlp_plan(1521, 384, 1536, dtype).splits > 1
    first = fused_mlp_block(*args)
    assert torch.equal(first, fused_mlp_block(*args))


def test_fused_mlp_rejects_unaligned_pointers_and_plans_it_does_not_take(cuda):
    args = _mlp_inputs(40, 96, torch.bfloat16, cuda, seed=7)
    flat = torch.empty(40 * 96 + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(40, 96)
    shifted.copy_(args[0])
    with pytest.raises(ValueError, match="16-byte"):
        fused_mlp_block(shifted, *args[1:])
    _launch_mlp(args, Plan(32, 4, 32, 32))  # a plan it takes
    torch.cuda.synchronize()
    for plan in [(48, 1, 32, 32),   # R not in {16, 32, 64}
                 (32, 5, 32, 32),   # S does not divide Hd = 384
                 (32, 1, 40, 32),   # BN not a multiple of 16
                 (32, 1, 80, 16),   # 5 n8 tiles a warp: not built; BN does not divide C
                 (32, 8, 32, 64),   # BK does not divide C = 96
                 (32, 1, 32, 48),   # BK not in {16, 32, 64}
                 (16, 1, 16, 16),   # R * BN not a multiple of 512
                 (32, 0, 32, 32)]:
        with pytest.raises(RuntimeError, match="CUDA error"):
            _launch_mlp(args, plan)


def test_eval_kernels_reject_bad_shapes(cuda):
    x = torch.zeros((1, 8, 8, 8, 24), device=cuda)
    with pytest.raises(ValueError, match="multiples of 16"):
        ln_partition_qkv(x, *_ln_qkv_inputs(24, torch.float32, cuda), (4, 4, 4))
    args = _mlp_inputs(8, 24, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        fused_mlp_block(*args)
    with pytest.raises(TypeError):
        fused_mlp_block(args[0].half(), *args[1:])


def test_global_norm_on_the_card_matches_the_cpu_form(cuda):
    """The card's ``global_norm`` (``_foreach_norm``) against the CPU's
    cascaded sums of squares on gradient leaves of the Swin-S FCOS model's
    shapes, each leaf at its own scale, at 1e-5."""
    from nerf_rpn_tpu_torch.models.nerf_rpn import FCOSOverNeRF
    from nerf_rpn_tpu_torch.train.state import global_norm

    shapes = [p.shape for p in FCOSOverNeRF("swin_s", 4, rotated=True).parameters()]
    rng = np.random.default_rng(23)
    leaves = [torch.from_numpy((rng.standard_normal(s) * 10.0 ** rng.uniform(-4, 1))
                               .astype(np.float32)) for s in shapes]
    assert sum(t.numel() for t in leaves) > 40_000_000
    want = global_norm(leaves)
    got = global_norm([t.to(cuda) for t in leaves])
    exact = np.sqrt(sum(float(np.sum(t.numpy().astype(np.float64) ** 2)) for t in leaves))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)
    assert abs(want.item() - exact) <= 1e-5 * exact


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_helper_on_the_card_matches_the_cpu_form(cuda, train, dtype):
    """``models/layers.batch_norm`` (flax's BatchNorm) on the card against
    the same call on the CPU, at resnet's stem (B 2 at 20x20x14, 64
    channels) and at resnet_tiny's stage 3 (B 4 at 1^3, 256 channels):
    outputs within 1e-5 of the largest (f32) or 2 bf16 ulps of it, the
    running statistics within 1e-5 (relative), one update a train call."""
    from nerf_rpn_tpu_torch.models.layers import batch_norm, bn3d

    for shape in [(2, 20, 20, 14, 64), (4, 1, 1, 1, 256)]:
        rng = np.random.default_rng(shape[0])
        x = torch.from_numpy(rng.normal(0.5, 2.0, shape).astype(np.float32)).to(dtype)
        c = shape[-1]
        bns = []
        for _ in range(2):
            bn = bn3d(c).train(train)
            with torch.no_grad():
                bn.weight.copy_(torch.from_numpy(np.linspace(0.5, 1.5, c, dtype=np.float32)))
                bn.bias.copy_(torch.from_numpy(np.linspace(-0.3, 0.3, c, dtype=np.float32)))
                bn.running_mean.fill_(0.2)
                bn.running_var.fill_(1.5)
            bns.append(bn)
        want = batch_norm(x, bns[0], dtype)
        got = batch_norm(x.to(cuda), bns[1].to(cuda), dtype)
        assert got.dtype == dtype
        scale = want.float().abs().max().item()
        tol = 1e-5 * scale if dtype == torch.float32 else 2 * 2.0 ** -7 * scale
        assert (got.cpu().float() - want.float()).abs().max().item() <= tol
        for name in ("running_mean", "running_var"):
            torch.testing.assert_close(getattr(bns[1], name).cpu(), getattr(bns[0], name),
                                       rtol=1e-5, atol=1e-6)
        assert int(bns[1].num_batches_tracked) == int(train)


@pytest.mark.parametrize("pool", ["stem_pool", "max_pool_2x2x2"])
def test_pools_under_deterministic_mode_match_the_cpu(cuda, pool):
    """Under ``torch.use_deterministic_algorithms(True)`` (the quality
    gate's mode on the card) a pool that needs a gradient runs its backward
    through ``index_put_``: forward equal to the CPU's, gradient within 1e-6
    (relative) of it, and bit-identical between two runs."""
    from nerf_rpn_tpu_torch.ops import pooling

    fn = getattr(pooling, pool)
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (2, 21, 20, 14, 8))
                         .astype(np.float32)).clamp(min=0)
    g_cpu = x.clone().requires_grad_()
    y_cpu = fn(g_cpu)
    up = torch.randn(y_cpu.shape, generator=torch.Generator().manual_seed(1))
    y_cpu.backward(up)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        grads = []
        for _ in range(2):
            xc = x.to(cuda).requires_grad_()
            y = fn(xc)
            assert torch.equal(y.cpu(), y_cpu.detach())
            y.backward(up.to(cuda))
            grads.append(xc.grad.cpu())
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], g_cpu.grad, rtol=1e-6, atol=1e-6)
