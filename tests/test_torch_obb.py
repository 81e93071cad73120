"""Torch port: OBB conversions, the OBB masks and the midpoint-offset coder vs JAX.

Same f32 inputs through ``nerf_rpn_tpu/ops/{obb,aabb,coders}.py`` and the
port's copies; floats within 1e-6 relative to each output's largest
magnitude (sin, cos, atan2, exp and log differ by an ulp between the two
libraries), masks exactly.

A rectangle's parameters are not unique, and two places in the code pick
one representative whose choice an ulp can flip:

- ``regular_obb`` swaps (w, l) when ``w > l``, so for squares and boxes
  with w and l within 1e-5 relative the two packages may return (w, l,
  theta) and (l, w, theta + pi/2) for the same box;
- ``regular_theta`` wraps angles into [-pi/2, pi/2), so an angle within an
  ulp of +-pi/2 may land on either end.

Where that holds, and only there, outputs are compared up to these
equivalences: the angle modulo pi, and the swapped form where w ~ l.  Every
other row must match directly.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.ops import aabb as jaabb
from nerf_rpn_tpu.ops import coders as jcoders
from nerf_rpn_tpu.ops import obb as jobb
from nerf_rpn_tpu_torch.ops import aabb, coders, obb

PI = math.pi
SQUARE_TOL = 1e-5  # relative w ~ l, where the swap may flip


def _obbs(rng, n, span=40.0, size=(2.0, 15.0)):
    ctr = rng.uniform(0, span, (n, 3))
    dims = rng.uniform(*size, (n, 3))
    theta = rng.uniform(-PI, PI, (n, 1))
    boxes = np.concatenate([ctr, dims, theta], -1).astype(np.float32)
    # squares, near-squares, theta at and next to +-pi/2, degenerate sizes
    boxes[0:8, 4] = boxes[0:8, 3]
    boxes[8:16, 4] = boxes[8:16, 3] * (1 + rng.uniform(-1e-6, 1e-6, 8))
    boxes[16:20, 6] = [PI / 2, -PI / 2, np.float32(PI / 2), np.nextafter(np.float32(-PI / 2), 0)]
    boxes[20:24, 6] = [PI / 4, -PI / 4, 0.0, PI]
    boxes[24, 3:6] = 0.0
    boxes[25, 3] = 0.0
    boxes[26, 4] = 0.0
    boxes[27, 5] = 0.0
    return boxes


def _close(got, want, tol=1e-6):
    """Rows of got within tol of want, relative to want's largest magnitude."""
    scale = np.abs(np.nan_to_num(want, posinf=0, neginf=0)).max() + 1e-30
    return np.all((np.abs(got - want) <= tol * scale) | (np.isnan(got) & np.isnan(want))
                  | (got == want), axis=-1)


def _angle_close(a, b, tol):
    d = np.remainder(a.astype(np.float64) - b, PI)
    return np.minimum(d, PI - d) <= tol


def _assert_obb_equivalent(got, want, iw, il, it, tol=1e-6):
    """Rows equal directly, or the same rectangle up to the angle modulo pi
    and, where w ~ l, the (w, l, theta) ~ (l, w, theta + pi/2) swap."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    direct = _close(got, want, tol)
    scale = np.abs(want).max()
    others = [i for i in range(want.shape[-1]) if i not in (iw, il, it)]
    same_rest = np.all(np.abs(got[:, others] - want[:, others]) <= tol * scale, axis=-1)
    same_sizes = np.all(np.abs(got[:, [iw, il]] - want[:, [iw, il]]) <= tol * scale, -1)
    swapped_sizes = np.all(np.abs(got[:, [iw, il]] - want[:, [il, iw]]) <= tol * scale, -1)
    near_square = np.abs(want[:, iw] - want[:, il]) <= SQUARE_TOL * np.abs(want[:, [iw, il]]).max(-1)
    wrap = same_rest & same_sizes & _angle_close(got[:, it], want[:, it], tol * scale)
    swap = (same_rest & near_square & swapped_sizes
            & _angle_close(got[:, it], want[:, it] + PI / 2, tol * scale))
    ok = direct | wrap | swap
    assert ok.all(), (np.flatnonzero(~ok), got[~ok], want[~ok])
    # the equivalences only cover angles at the wrap and near-squares
    at_wrap = np.abs(np.abs(want[:, it]) - PI / 2) <= 1e-5
    assert np.all(direct | at_wrap | near_square)


def test_regular_theta_and_regular_obb():
    rng = np.random.default_rng(0)
    theta = rng.uniform(-10, 10, 500).astype(np.float32)
    theta[:6] = [PI / 2, -PI / 2, PI, -PI, 0.0, 3 * PI / 2]
    for mode, start in (("180", -PI / 2), ("360", -PI), ("180", 0.0)):
        got = obb.regular_theta(torch.from_numpy(theta), mode, start).numpy()
        want = np.asarray(jobb.regular_theta(jnp.asarray(theta), mode, start))
        cycle = PI if mode == "180" else 2 * PI
        d = np.remainder(got.astype(np.float64) - want, cycle)
        assert np.all(np.minimum(d, cycle - d) <= 1e-6 * 10), mode
        assert np.all((got >= start - 1e-6) & (got < start + cycle + 1e-6))
    b = _obbs(rng, 300)
    obb2d = b[:, [0, 1, 3, 4, 6]]
    got = obb.regular_obb(torch.from_numpy(obb2d)).numpy()
    want = np.asarray(jobb.regular_obb(jnp.asarray(obb2d)))
    _assert_obb_equivalent(got, want, 2, 3, 4)


def test_polygons_hbbs_and_points():
    b = _obbs(np.random.default_rng(1), 300)
    t, j = torch.from_numpy(b), jnp.asarray(b)
    t2, j2 = t[:, [0, 1, 3, 4, 6]], j[:, jnp.array([0, 1, 3, 4, 6])]
    pairs = [
        (obb.obb2poly(t2), jobb.obb2poly(j2)),
        (obb.obb2poly_3d(t), jobb.obb2poly_3d(j)),
        (obb.obb2hbb(t2), jobb.obb2hbb(j2)),
        (obb.obb2hbb_3d(t), jobb.obb2hbb_3d(j)),
        (obb.obb2points_3d(t).reshape(-1, 6), jobb.obb2points_3d(j).reshape(-1, 6)),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape
        assert _close(got.numpy(), want).all()


def test_rectpoly2obb_round_trips():
    b = _obbs(np.random.default_rng(2), 300)[:, [0, 1, 3, 4, 6]]
    b = b[b[:, 2] * b[:, 3] > 0]  # a degenerate polygon has no first edge
    polys = np.array(jobb.obb2poly(jnp.asarray(b)))
    got = obb.rectpoly2obb(torch.from_numpy(polys)).numpy()
    want = np.asarray(jobb.rectpoly2obb(jnp.asarray(polys)))
    _assert_obb_equivalent(got, want, 2, 3, 4)


def test_obb_masks_match_jax():
    rng = np.random.default_rng(3)
    b = _obbs(rng, 400, span=50.0)
    b[:4, :3] = [[0, 0, 0], [40, 30, 45], [40.0001, 3, 3], [-1e-6, 5, 5]]  # on / off the edges
    grid = np.array([40.0, 30.0, 45.0], np.float32)
    got = aabb.obb_center_valid_mask(torch.from_numpy(b), torch.from_numpy(grid))
    want = jaabb.obb_center_valid_mask(jnp.asarray(b), jnp.asarray(grid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < len(b)
    for min_size in (1e-3, 3.0, 8.0):
        for boxes in (b, np.concatenate([b[:, :3], b[:, :3] + b[:, 3:6]], -1)):
            np.testing.assert_array_equal(
                aabb.small_box_mask(torch.from_numpy(boxes), min_size).numpy(),
                np.asarray(jaabb.small_box_mask(jnp.asarray(boxes), min_size)))


def _anchors(rng, n):
    lo = rng.uniform(0, 40, (n, 3))
    return np.concatenate([lo, lo + rng.uniform(3, 20, (n, 3))], -1).astype(np.float32)


def test_encode_midpoint_offset_matches_jax():
    rng = np.random.default_rng(4)
    gt = _obbs(rng, 300)
    anchors = _anchors(rng, 300)
    got = coders.encode_midpoint_offset(torch.from_numpy(gt), torch.from_numpy(anchors)).numpy()
    want = np.asarray(jcoders.encode_midpoint_offset(jnp.asarray(gt), jnp.asarray(anchors)))
    assert got.shape == (300, 8)
    # the degenerate rows divide by a zero size, in both packages alike
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want).all(-1)
    assert fin.sum() >= 290
    # the corner offsets (cols 6, 7) pick the corner(s) on an edge within
    # _MID_TOL, so they are compared per column scale
    for c in range(8):
        w = want[fin, c]
        np.testing.assert_allclose(got[fin, c], w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                   err_msg=str(c))


@pytest.mark.parametrize("limits", [False, True])
def test_decode_midpoint_offset_matches_jax(limits):
    rng = np.random.default_rng(5)
    anchors = _anchors(rng, 400)
    deltas = rng.normal(0, 0.3, (400, 8)).astype(np.float32)
    deltas[:4, 6:] = 0.0  # the diamond of a square anchor: w ~ l
    anchors[:4, 3:] = anchors[:4, :3] + 10.0
    if limits:
        # sizes at and past the wh-ratio clip, corner offsets at and past +-0.5
        lim = abs(math.log(16 / 1000))
        deltas[:, 3:6] = rng.choice([-lim, lim, -20.0, 20.0, 0.0], (400, 3))
        deltas[:, 6:8] = rng.choice([-0.5, 0.5, -0.9, 0.9, 0.0], (400, 2))
    got = coders.decode_midpoint_offset(torch.from_numpy(deltas), torch.from_numpy(anchors))
    want = np.asarray(jcoders.decode_midpoint_offset(jnp.asarray(deltas), jnp.asarray(anchors)))
    assert got.shape == (400, 7)
    got = got.numpy()
    if limits:  # decoding clamps past the limits: same boxes as at them
        clamped = deltas.copy()
        clamped[:, 3:6] = np.clip(clamped[:, 3:6], -lim, lim)
        clamped[:, 6:8] = np.clip(clamped[:, 6:8], -0.5, 0.5)
        again = coders.decode_midpoint_offset(torch.from_numpy(clamped), torch.from_numpy(anchors))
        np.testing.assert_array_equal(again.numpy(), got)
    _assert_obb_equivalent(got, want, 3, 4, 6)


def test_midpoint_offset_round_trips():
    rng = np.random.default_rng(6)
    gt = _obbs(rng, 300, size=(4.0, 15.0))[28:]
    anchors = np.concatenate([gt[:, :3] - gt[:, 3:6] * 0.6, gt[:, :3] + gt[:, 3:6] * 0.6], -1)
    enc = coders.encode_midpoint_offset(torch.from_numpy(gt), torch.from_numpy(anchors))
    back = coders.decode_midpoint_offset(enc, torch.from_numpy(anchors)).numpy()
    ref = np.asarray(jcoders.decode_midpoint_offset(
        jcoders.encode_midpoint_offset(jnp.asarray(gt), jnp.asarray(anchors)),
        jnp.asarray(anchors)))
    _assert_obb_equivalent(back, ref, 3, 4, 6)
    # the boxes come back (as rectangles: the same corners) where one corner
    # lies on each edge; nearer the axes the coder's _MID_TOL of 0.1 takes
    # the larger of two corners on an edge, in both packages
    tilted = np.abs(np.sin(2 * gt[:, 6])) > 0.3
    assert tilted.sum() > 100
    corners = obb.obb2poly_3d(torch.from_numpy(back)).numpy().reshape(-1, 8, 3)
    want = obb.obb2poly_3d(torch.from_numpy(gt)).numpy().reshape(-1, 8, 3)
    d = np.abs(corners[:, :, None] - want[:, None]).max(-1).min(-1)
    assert d[tilted].max() <= 1e-3, d[tilted].max()


def test_rotated_config_codes_through_the_midpoint_coder():
    from nerf_rpn_tpu_torch.models.rpn import RPNConfig

    cfg = RPNConfig(rotated=True)
    assert (cfg.box_dim, cfg.delta_dim) == (7, 8)
    assert (RPNConfig().box_dim, RPNConfig().delta_dim) == (6, 6)
    rng = np.random.default_rng(7)
    gt, anchors = torch.from_numpy(_obbs(rng, 50)[28:]), torch.from_numpy(_anchors(rng, 22))
    assert torch.equal(cfg.encode(gt, anchors), coders.encode_midpoint_offset(gt, anchors))
    d = cfg.encode(gt, anchors)
    assert torch.equal(cfg.decode(d, anchors), coders.decode_midpoint_offset(d, anchors))
