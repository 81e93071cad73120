"""Torch port: RoI align (``nerf_rpn_tpu_torch/ops/roi_align.py``) against
``nerf_rpn_tpu/ops/roi_align.py`` on the same inputs.

Inputs are made from a seed with numpy.  Tolerances: f32 values within
1e-5 of the output's largest entry; the gradient with respect to the
features (JAX's ``vjp`` against torch autograd) within 1e-5 of its
largest entry; bf16 features (the product promotes to f32) within 1e-5 as
well, since the gather itself rounds nothing.  The levels of the numpy
mapper match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.ops import roi_align as jra
from nerf_rpn_tpu_torch.ops import roi_align as tra

SCALES = (4.0, 8.0, 16.0, 32.0)
LEVEL_DIMS = [(8, 8, 6), (4, 4, 3), (2, 2, 2), (1, 1, 1)]  # a 32x32x24 scene


def close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1.0), err


def _rois(rng, n, rotated):
    """RoIs in mesh units over a 32x32x24 scene, some poking out of it."""
    ctr = rng.uniform(-2, 34, (n, 3)).astype(np.float32)
    ctr[:, 2] *= 0.75
    size = rng.uniform(2, 20, (n, 3)).astype(np.float32)
    if rotated:
        theta = rng.uniform(-np.pi / 2, np.pi / 2, (n, 1)).astype(np.float32)
        return np.concatenate([ctr, size, theta], -1)
    return np.concatenate([ctr - size / 2, ctr + size / 2], -1)


def _pyramid(rng, b, c=16):
    return [rng.standard_normal((b, *d, c)).astype(np.float32) for d in LEVEL_DIMS]


@pytest.mark.parametrize("mode", ["avg", "max"])
def test_single_level_matches_jax(mode):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((10, 9, 7, 8)).astype(np.float32)
    rois = _rois(rng, 24, rotated=True) / 3
    want = jra.roi_align_rotated_3d(jnp.asarray(feats), jnp.asarray(rois), 0.5, (2, 3, 2), 2,
                                    mode)
    got = tra.roi_align_rotated_3d(torch.from_numpy(feats), torch.from_numpy(rois), 0.5,
                                   (2, 3, 2), 2, mode)
    close(got, want)


@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
@pytest.mark.parametrize("mode", ["avg", "max"])
def test_batched_multilevel_matches_jax(rotated, mode):
    rng = np.random.default_rng(1 + rotated)
    b, r = 2, 40
    feats = _pyramid(rng, b)
    rois = np.stack([_rois(rng, r, rotated) for _ in range(b)])
    levels = rng.integers(-1, 5, (b, r)).astype(np.int32)   # -1 and 4 out of range
    valid = rng.uniform(size=(b, r)) > 0.2
    args = (SCALES, (3, 3, 3), 2, mode, rotated, 0.2)
    want = jra.multilevel_roi_align_batched([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                                            jnp.asarray(levels), jnp.asarray(valid), *args)
    got = tra.multilevel_roi_align_batched([torch.from_numpy(f) for f in feats],
                                           torch.from_numpy(rois), torch.from_numpy(levels),
                                           torch.from_numpy(valid), *args)
    close(got, want)
    out_of_range = (levels < 0) | (levels > 3) | ~valid
    assert np.all(got.numpy()[out_of_range] == 0)
    assert np.abs(got.numpy()[~out_of_range]).max() > 0
    # one scene alone: the unbatched form
    one = jra.multilevel_roi_align([jnp.asarray(f[1]) for f in feats], jnp.asarray(rois[1]),
                                   jnp.asarray(levels[1]), jnp.asarray(valid[1]), *args)
    got1 = tra.multilevel_roi_align([torch.from_numpy(f[1]) for f in feats],
                                    torch.from_numpy(rois[1]), torch.from_numpy(levels[1]),
                                    torch.from_numpy(valid[1]), *args)
    close(got1, one)


def test_bf16_features_promote_to_f32():
    rng = np.random.default_rng(3)
    feats = _pyramid(rng, 2)
    rois = np.stack([_rois(rng, 12, True) for _ in range(2)])
    levels = rng.integers(0, 4, (2, 12)).astype(np.int32)
    valid = np.ones((2, 12), bool)
    args = (SCALES, (2, 2, 2), 2, "avg", True, 0.2)
    want = jra.multilevel_roi_align_batched(
        [jnp.asarray(f, jnp.bfloat16) for f in feats], jnp.asarray(rois), jnp.asarray(levels),
        jnp.asarray(valid), *args)
    got = tra.multilevel_roi_align_batched(
        [torch.from_numpy(f).bfloat16() for f in feats], torch.from_numpy(rois),
        torch.from_numpy(levels), torch.from_numpy(valid), *args)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close(got, want)


@pytest.mark.parametrize("offset", [0.0, 2.0 ** -10], ids=["on_edge", "past_edge"])
def test_samples_on_and_past_the_last_voxel(offset):
    """Level 0 is 8 voxels wide: a sample exactly on x = 7 counts (its upper
    corners clamp onto 7), one 2^-10 past it makes the whole sample zero."""
    rng = np.random.default_rng(4)
    feats = _pyramid(rng, 1, c=4)
    # mesh centre 25 (grid 6.25) and size 8 (grid 2): the last sample of
    # the last bin sits at 6.25 + 0.375 * 2 = 7 exactly
    c = 25.0 + 4 * offset
    rois = np.array([[[c - 4, 12, 8, c + 4, 20, 16]]], np.float32)
    args = (SCALES, (2, 2, 2), 2, "avg", False, 0.0)
    inputs = (rois, np.zeros((1, 1), np.int32), np.ones((1, 1), bool))
    want = jra.multilevel_roi_align_batched([jnp.asarray(f) for f in feats],
                                            *map(jnp.asarray, inputs), *args)
    got = tra.multilevel_roi_align_batched([torch.from_numpy(f) for f in feats],
                                           *map(torch.from_numpy, inputs), *args)
    close(got, want, 1e-6)
    last = got.numpy()[0, 0, 1]       # the bins whose samples reach x = 7
    first = got.numpy()[0, 0, 0]
    if offset:
        # half the samples of the last x bin fall out: its mean is that of
        # the in-grid half alone, so it differs from the on-edge case
        roi = torch.tensor([[6.25 + offset, 4.0, 3.0, 2.0, 2.0, 2.0, 0.0]])
        pts = tra.roi_sample_points(roi, (2, 2, 2), 2)
        assert (pts[..., 0] > 7).sum() == 16
    assert np.abs(last).max() > 0 and np.abs(first).max() > 0


def test_gradient_wrt_features_matches_jax_vjp():
    rng = np.random.default_rng(5)
    b, r = 2, 16
    feats = _pyramid(rng, b, c=8)
    rois = np.stack([_rois(rng, r, True) for _ in range(b)])
    levels = rng.integers(0, 4, (b, r)).astype(np.int32)
    valid = rng.uniform(size=(b, r)) > 0.1
    cot = rng.standard_normal((b, r, 2, 2, 2, 8)).astype(np.float32)
    args = (SCALES, (2, 2, 2), 2, "avg", True, 0.2)

    def jfn(*fs):
        return jra.multilevel_roi_align_batched(list(fs), jnp.asarray(rois), jnp.asarray(levels),
                                                jnp.asarray(valid), *args)

    _, vjp = jax.vjp(jfn, *[jnp.asarray(f) for f in feats])
    want = vjp(jnp.asarray(cot))
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)   # as the card's quality gate runs
    try:
        out = tra.multilevel_roi_align_batched(tf, torch.from_numpy(rois),
                                               torch.from_numpy(levels),
                                               torch.from_numpy(valid), *args)
        out.backward(torch.from_numpy(cot))
    finally:
        torch.use_deterministic_algorithms(was)
    for t, w in zip(tf, want):
        close(t.grad, w)
    assert np.abs(tf[0].grad.numpy()).max() > 0


def test_map_rois_to_levels_np_matches_exactly():
    rng = np.random.default_rng(6)
    lo = rng.uniform(0, 200, (4000, 3)).astype(np.float32)
    aabb = np.concatenate([lo, lo + rng.uniform(0, 300, (4000, 3)).astype(np.float32)], -1)
    aabb[:5, 3:] = aabb[:5, :3]                       # zero volume
    obb = np.concatenate([rng.uniform(0, 200, (4000, 3)), rng.uniform(0, 300, (4000, 3)),
                          rng.uniform(-1, 1, (4000, 1))], -1).astype(np.float32)
    for boxes in (aabb, obb):
        for k_min, k_max in ((0, 3), (2, 5)):
            want = jra.map_rois_to_levels_np(boxes, k_min, k_max)
            np.testing.assert_array_equal(tra.map_rois_to_levels_np(boxes, k_min, k_max), want)
            # the torch mapper: the same levels off the exact boundaries
            # (a cube root by pow may differ from cbrt in the last bit)
            ok = boxes[5:] if boxes is aabb else boxes
            jt = np.asarray(jra.map_rois_to_levels(jnp.asarray(ok), k_min, k_max))
            tt = tra.map_rois_to_levels(torch.from_numpy(ok), k_min, k_max).numpy()
            assert (jt != tt).mean() < 1e-3
