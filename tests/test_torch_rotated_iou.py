"""Torch port: rotated 3D IoU of box pairs vs JAX.

The port's ``ops/rotated_iou_pairwise`` (trailing vertex axes, one stable
``torch.sort``) against the JAX package's structure-of-arrays module
(``pairwise_iou_rotated_3d_soa``, its bitonic network) and its general
chain (``rotated_iou.pairwise_iou_rotated_3d``, an argsort by atan2), on
the same f32 boxes: IoUs within 1e-5 absolute.  Cases: identical, nested,
disjoint and edge-sharing boxes, 90-degree turns, and random pairs; the
upper bound that gates the NMS clipping is held to the exact IoU and to
JAX's bound.

The general JAX chain returns an impossible IoU of 1.0055 for one box and
its copy turned by 90 degrees with w and l swapped (seed 0, row 16: theta
1.532 against 3.103).  Its structure-of-arrays module, and the port, give
1.0 there.  So the comparison with the chain skips the pairs where the
chain's IoU exceeds 1 + 1e-5, and asserts that they are only such pairs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.ops import rotated_iou as jri
from nerf_rpn_tpu.ops import rotated_iou_pairwise as jrp
from nerf_rpn_tpu_torch.ops import rotated_iou_pairwise as rp

ATOL = 1e-5


def _random(rng, n, span=30.0, size=(2.0, 12.0)):
    ctr = rng.uniform(0, span, (n, 3))
    dims = rng.uniform(*size, (n, 3))
    theta = rng.uniform(-math.pi / 2, math.pi / 2, (n, 1))
    return np.concatenate([ctr, dims, theta], -1).astype(np.float32)


def _special_pairs():
    """(boxes1, boxes2, expected IoU or None) rows of the named cases."""
    b = np.array([10.0, 12.0, 5.0, 6.0, 4.0, 2.0, 0.3], np.float32)
    rows = []
    rows.append((b, b, 1.0))                                              # identical
    inner = b.copy()
    inner[3:6] *= 0.5
    rows.append((b, inner, 0.125))                                        # nested, same centre
    far = b.copy()
    far[0] += 50.0
    rows.append((b, far, 0.0))                                            # disjoint in x-y
    above = b.copy()
    above[2] += 3.0
    rows.append((b, above, 0.0))                                          # disjoint in z only
    a0 = np.array([0.0, 0.0, 0.0, 4.0, 2.0, 2.0, 0.0], np.float32)
    side = a0.copy()
    side[0] = 4.0
    rows.append((a0, side, 0.0))                                          # sharing an edge
    half = a0.copy()
    half[0] = 2.0
    rows.append((a0, half, 1.0 / 3.0))                                    # half overlap, axis-aligned
    turned = b.copy()
    turned[6] += math.pi / 2
    turned[3], turned[4] = b[4], b[3]
    rows.append((b, turned, 1.0))                                         # 90 deg turn, sizes swapped
    cross = a0.copy()
    cross[6] = math.pi / 2
    rows.append((a0, cross, 4.0 * 2.0 / (16.0 + 16.0 - 8.0)))             # a cross: 2x2 core
    tilt = a0.copy()
    tilt[6] = math.pi / 4
    rows.append((a0, tilt, None))                                         # 45 deg turn
    return [np.stack(c) for c in zip(*[(r[0], r[1]) for r in rows])], [r[2] for r in rows]


def test_named_cases_match_jax_and_geometry():
    (b1, b2), expected = _special_pairs()
    t1, t2 = torch.from_numpy(b1), torch.from_numpy(b2)
    got = rp.iou_rotated_3d_pairs_soa(t1, t2).numpy()
    want = np.asarray(jrp.iou_rotated_3d_pairs_soa(jnp.asarray(b1), jnp.asarray(b2)))
    want_chain = np.asarray(jri.iou_rotated_3d(jnp.asarray(b1), jnp.asarray(b2)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_chain, rtol=0, atol=ATOL)
    for i, e in enumerate(expected):
        if e is not None:
            assert abs(got[i] - e) <= ATOL, (i, got[i], e)
    # the pairwise form's diagonal is the elementwise form
    full = rp.pairwise_iou_rotated_3d_soa(t1, t2).numpy()
    np.testing.assert_array_equal(np.diag(full), got)


@pytest.mark.parametrize("seed,size", [(0, (2.0, 12.0)), (1, (0.5, 30.0))])
def test_random_pairwise_matches_both_jax_forms(seed, size):
    rng = np.random.default_rng(seed)
    b1, b2 = _random(rng, 120, size=size), _random(rng, 90, size=size)
    # a few exact copies and 90-degree turns of the first rows
    b2[:10] = b1[:10]
    b2[10:20] = b1[10:20]
    b2[10:20, 6] += math.pi / 2
    b2[10:20, 3], b2[10:20, 4] = b1[10:20, 4], b1[10:20, 3]
    got = rp.pairwise_iou_rotated_3d_soa(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    assert got.shape == (120, 90)
    want = np.asarray(jrp.pairwise_iou_rotated_3d_soa(jnp.asarray(b1), jnp.asarray(b2)))
    want_chain = np.asarray(jri.pairwise_iou_rotated_3d(jnp.asarray(b1), jnp.asarray(b2)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert got.max() <= 1 + ATOL
    sound = want_chain <= 1 + ATOL
    assert (~sound).sum() <= 1
    np.testing.assert_allclose(got[sound], want_chain[sound], rtol=0, atol=ATOL)
    assert (got > 0).mean() > 0.05
    idx = np.arange(20)
    np.testing.assert_allclose(got[idx, idx], 1.0, atol=ATOL)


def test_upper_bound_bounds_the_exact_iou_and_matches_jax():
    rng = np.random.default_rng(2)
    b1, b2 = _random(rng, 300), _random(rng, 250)
    t1, t2 = torch.from_numpy(b1), torch.from_numpy(b2)
    ub = rp.iou_rotated_3d_upper_bound(t1, t2)
    exact = rp.pairwise_iou_rotated_3d_soa(t1, t2)
    assert torch.all(ub >= exact - 1e-3)
    assert (exact > 0).float().mean() > 0.05
    want = np.asarray(jrp.iou_rotated_3d_upper_bound(jnp.asarray(b1), jnp.asarray(b2)))
    np.testing.assert_allclose(ub.numpy(), want, rtol=0, atol=ATOL)
    # batched over leading problems, as the NMS graph build calls it
    both = rp.iou_rotated_3d_upper_bound(torch.stack([t1[:200], t2[:200]]),
                                         torch.stack([t2[:200], t1[:200]]))
    assert torch.equal(both[0], ub[:200, :200])
