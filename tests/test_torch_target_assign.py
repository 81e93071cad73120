"""Torch port: anchor matching and balanced sampling vs the JAX package.

``match_anchors`` must equal JAX's output exactly on random gt boxes with
padded gt rows, padded anchors and forced ties.  The sampler is held to
JAX's index output when both get the same uniform priorities (JAX's own
``jax.random.uniform`` draws, injected), and to its budget, eligibility,
no-duplicate and seeded-determinism contract with its own generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.models.rpn import RPNConfig as JRPNConfig
from nerf_rpn_tpu.models.rpn import build_level_tables as jax_level_tables
from nerf_rpn_tpu.ops.aabb import pairwise_iou_aabb as jax_iou
from nerf_rpn_tpu.utils import target_assign as jta
from nerf_rpn_tpu_torch.ops.aabb import pairwise_iou_aabb
from nerf_rpn_tpu_torch.utils.target_assign import match_anchors, sample_balanced_indices

MESH = (32, 32, 32)
LEVELS = [(8, 8, 8), (4, 4, 4), (2, 2, 2), (1, 1, 1)]


@pytest.fixture(scope="module")
def anchors():
    a, _, _, _ = jax_level_tables(JRPNConfig(), MESH, LEVELS)
    return a.astype(np.float32)


def _gt(rng, g, n_valid):
    lo = rng.uniform(0, 24, (g, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(2, 12, (g, 3))], -1).astype(np.float32)
    valid = np.zeros(g, bool)
    valid[:n_valid] = True
    boxes[~valid] = 0.0  # zero-padded rows, as collate_batch pads them
    return boxes, valid


def _both(iou, valid, hi=0.35, lo=0.2):
    want = np.asarray(jta.match_anchors(jnp.asarray(iou), jnp.asarray(valid), hi, lo))
    got = match_anchors(torch.from_numpy(iou), torch.from_numpy(valid), hi, lo).numpy()
    return got, want


@pytest.mark.parametrize("seed,n_valid", [(0, 5), (1, 1), (2, 16), (3, 0)])
def test_match_anchors_exact_on_real_anchors(anchors, seed, n_valid):
    rng = np.random.default_rng(seed)
    boxes, valid = _gt(rng, 16, n_valid)
    # the port's IoU bits must equal JAX's for the exact-equality force-match
    iou = pairwise_iou_aabb(torch.from_numpy(boxes), torch.from_numpy(anchors)).numpy()
    np.testing.assert_array_equal(iou, np.asarray(jax_iou(jnp.asarray(boxes), jnp.asarray(anchors))))
    pad = rng.random(anchors.shape[0]) < 0.9  # padded anchors: IoU -1
    iou = np.where(pad[None], iou, -1.0).astype(np.float32)
    got, want = _both(iou, valid)
    np.testing.assert_array_equal(got, want)
    if n_valid:
        assert (got >= 0).any() and (got == -1).any()


def test_match_anchors_exact_on_forced_ties():
    rng = np.random.default_rng(4)
    # quantised IoUs: many exact ties in the argmax and at each gt's best
    iou = (rng.integers(0, 8, (6, 300)) / 10.0).astype(np.float32)
    iou[:, 100:110] = 0.25            # a column block tied across gts
    iou[2, 200:205] = iou[2].max()    # several best anchors for one gt
    valid = np.array([True, True, True, True, False, False])
    iou[4:, :50] = 0.9                # padded rows never win
    got, want = _both(iou, valid)
    np.testing.assert_array_equal(got, want)


def _jax_sample(key, matches, batch, frac):
    out = jta.sample_balanced_indices(key, jnp.asarray(matches), batch, frac)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("batch,frac,n", [(256, 0.5, 3000), (64, 0.25, 500), (256, 0.5, 100)])
def test_sampler_equals_jax_on_the_same_priorities(batch, frac, n):
    rng = np.random.default_rng(5)
    matches = rng.choice([-2, -1, -1, -1, 0, 1, 2], size=(2, n)).astype(np.int32)
    matches[1, : n // 2] = -2  # a scene with fewer candidates
    key = jax.random.PRNGKey(7)
    kp, kn = jax.random.split(key)
    prio = tuple(torch.from_numpy(np.array(jax.random.uniform(k, matches.shape)))
                 for k in (kp, kn))
    got = sample_balanced_indices(torch.from_numpy(matches).long(), batch, frac,
                                  priorities=prio)
    for g, w in zip(got, _jax_sample(key, matches, batch, frac)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_sampler_budgets_eligibility_and_determinism():
    rng = np.random.default_rng(6)
    n = 2000
    matches = np.full((3, n), -2, np.int64)
    matches[0, rng.choice(n, 40, replace=False)] = 0      # few positives
    matches[0, rng.choice(np.flatnonzero(matches[0] == -2), 1500, replace=False)] = -1
    matches[1, :300] = 1                                   # many positives
    matches[1, 300:310] = -1                               # few negatives
    matches[2, :] = -1                                     # no positive
    m = torch.from_numpy(matches)
    out = sample_balanced_indices(m, 256, 0.5, generator=torch.Generator().manual_seed(0))
    again = sample_balanced_indices(m, 256, 0.5, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    other = sample_balanced_indices(m, 256, 0.5, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(out[0][1], other[0][1])
    pos_idx, pos_take, neg_idx, neg_take = (t.numpy() for t in out)
    assert pos_idx.shape == (3, 256)
    n_pos, n_neg = pos_take.sum(1), neg_take.sum(1)
    np.testing.assert_array_equal(n_pos, [40, 128, 0])
    np.testing.assert_array_equal(n_neg, [216, 10, 256])
    for i in range(3):
        p, q = pos_idx[i][pos_take[i]], neg_idx[i][neg_take[i]]
        assert len(set(p)) == len(p) and len(set(q)) == len(q)
        assert (matches[i][p] >= 0).all() and (matches[i][q] == -1).all()
