"""K5's slab form (``ops/fused_ln_qkv.XSlab``) against the whole-grid twin,
and the space axis's input split.

For each rank of a space group of 2 or 3 and each shift, the twin given a
rank's slab (``rank_slab``: the rolled frame's rows of its window columns
with the pad rows set to NaN, which must never be read; its real rows
without an x shift) is the whole-grid twin ``ln_partition_qkv_reference``
-- itself held to JAX's ``ln_partition_qkv`` by
``test_torch_fused_ln_qkv.py`` -- sliced to the rank's windows: in f64
within 1e-12 of the largest entry (the products run over other row counts),
in bf16 within 2 bf16 ulps of the largest.  Grids: 13 tokens over 4 window
columns (a stage 2 of the bench: the last rank's slab holds the global
pad rows 13-15 between real rows 10-12 and the wrapped rows 0-1), 17 over
5 (the odd x extent of ``torch_space_cases.py``), 7 over 2 (a stage 3).
The origin-0 slab of the whole grid is the call without a slab, bit for
bit; a slab whose real rows lie past x, and a grid whose x extent does
not divide over the space group, are refused.
"""

import numpy as np
import pytest
import torch

from nerf_rpn_tpu_torch.ops.fused_ln_qkv import (XSlab, ln_partition_qkv,
                                                  ln_partition_qkv_reference, rank_slab)
from nerf_rpn_tpu_torch.parallel import space as sp

WINDOW = (4, 4, 4)


def _inputs(size, c, dtype, b=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, *size, c), generator=gen, dtype=torch.float64).to(dtype)
    s = 1 + 0.2 * torch.randn(c, generator=gen, dtype=torch.float64)
    t = 0.2 * torch.randn(c, generator=gen, dtype=torch.float64)
    w = (torch.randn((c, 3 * c), generator=gen, dtype=torch.float64) * c ** -0.5).to(dtype)
    bias = 0.5 * torch.randn(3 * c, generator=gen, dtype=torch.float64)
    if dtype != torch.float64:
        s, t, bias = s.float(), t.float(), bias.float()
    return x, (s, t, w, bias)


def _windows_of(out, b, size, cols):
    """The whole grid's output rows of the rank's window columns."""
    nx, ny, nz = (-(-n // 4) for n in size)
    return out.reshape(b, nx, ny * nz, *out.shape[1:])[:, cols[0]:cols[1]].reshape(
        -1, *out.shape[1:])


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("shift", [(0, 0, 0), (2, 2, 2)])
@pytest.mark.parametrize("n_space", [2, 3])
@pytest.mark.parametrize("size", [(13, 6, 5), (17, 4, 6), (7, 5, 5)])
def test_slab_twin_is_the_whole_grid_twin_sliced(size, n_space, shift, dtype):
    c = 16
    x, params = _inputs(size, c, dtype)
    pad = tuple(-(-n // 4) * 4 for n in size)
    shift = tuple(0 if p <= 4 else s for s, p in zip(shift, pad))  # the model's rule
    whole = ln_partition_qkv_reference(x, *params, WINDOW, pad, shift)
    _, cols = sp.window_bounds(size[0], 4, n_space)
    for rank_cols in cols:
        xs, slab = rank_slab(x, WINDOW, pad, shift, rank_cols)
        got = ln_partition_qkv(xs, *params, WINDOW, pad, shift, slab)
        want = _windows_of(whole, x.shape[0], size, rank_cols)
        assert got.shape == want.shape
        if not want.numel():
            continue
        err = (got.double() - want.double()).abs().max().item()
        scale = want.double().abs().max().item()
        if dtype == torch.float64:
            assert err <= 1e-12 * scale, (rank_cols, err)
        else:
            assert err <= 2 * 2.0 ** -7 * 2.0 ** np.floor(np.log2(scale)), (rank_cols, err)


def test_last_slab_holds_pad_rows_between_real_rows():
    """13 tokens, P 16, shift 2, two ranks: the last rank's rolled rows
    10-12 are real, 13-15 pad, then the wrapped 0-1."""
    x, _ = _inputs((13, 4, 4), 16, torch.float64)
    xs, slab = rank_slab(x, WINDOW, (16, 4, 4), (2, 0, 0), (2, 4))
    assert slab == XSlab(10, 13, 2, 2)
    assert torch.isnan(xs[:, 3:6]).all() and not torch.isnan(xs[:, :3]).any()
    assert torch.equal(xs[:, 6:8], x[:, :2])


@pytest.mark.parametrize("shift", [(0, 0, 0), (2, 2, 2)])
def test_origin_zero_slab_is_the_call_without_one(shift):
    size = (9, 8, 11)
    x, params = _inputs(size, 16, torch.float32)
    pad = tuple(-(-n // 4) * 4 for n in size)
    whole = XSlab(0, size[0], 0, pad[0] // 4)
    assert torch.equal(ln_partition_qkv(x, *params, WINDOW, pad, shift, whole),
                       ln_partition_qkv(x, *params, WINDOW, pad, shift))


def test_slab_reading_past_x_is_refused():
    x, params = _inputs((13, 4, 4), 16, torch.float64)
    xs, slab = rank_slab(x, WINDOW, (16, 4, 4), (2, 0, 0), (2, 4))
    with pytest.raises(ValueError, match="past"):
        ln_partition_qkv(xs[:, :6], *params, WINDOW, (16, 4, 4), (2, 0, 0), slab)
    with pytest.raises(ValueError, match="does not fit"):
        ln_partition_qkv(xs, *params, WINDOW, (16, 4, 4), (2, 0, 0), XSlab(16, 13, 2, 2))


def _layout(n_data, n_space, data_index, space_index):
    return sp.SpaceGroups(n_data, n_space, data_index, space_index)


def test_x_extent_not_divisible_by_the_space_axis_is_refused():
    """As ``mesh.shard_batch`` (``nerf_rpn_tpu/parallel/mesh.py:184-190``)."""
    batch = {"grids": torch.zeros((2, 66, 4, 4, 4)), "ori_sizes": torch.zeros((2, 3))}
    with pytest.raises(ValueError, match="not divisible by the space axis"):
        sp.shard_batch(batch, _layout(1, 4, 0, 0))
    with pytest.raises(ValueError, match="not divisible by the space axis"):
        sp.shard_grid(batch["grids"], _layout(2, 4, 1, 3))


def test_shard_batch_splits_grids_over_both_axes_and_the_rest_over_data():
    grids = torch.arange(2 * 66 * 2, dtype=torch.float32).reshape(2, 66, 2, 1, 1)
    gt = torch.arange(2 * 3 * 6, dtype=torch.float32).reshape(2, 3, 6)
    batch = {"grids": grids, "gt_boxes": gt, "names": ["a", "b"]}
    part = sp.shard_batch(batch, _layout(2, 2, 1, 0))
    assert set(part) == {"grids", "gt_boxes"}
    assert torch.equal(part["grids"], grids[1:2, :33])
    assert torch.equal(part["gt_boxes"], gt[1:2])
    assert torch.equal(sp.shard_grid(grids, _layout(1, 2, 0, 1)), grids[:, 33:])


@pytest.mark.parametrize("extent,n,want", [(52, 2, ((0, 28), (28, 52))),
                                           (13, 2, ((0, 8), (8, 13))),
                                           (4, 2, ((0, 4), (4, 4))),
                                           (17, 3, ((0, 8), (8, 16), (16, 17)))])
def test_window_bounds(extent, n, want):
    rows, cols = sp.window_bounds(extent, 4, n)
    assert rows == want
    assert all(r == (min(a * 4, extent), min(b * 4, extent)) for r, (a, b) in zip(rows, cols))
