"""Torch port: the NMS resolve step (greedy keep-set from K3's graph) vs JAX.

The resolve kernel of ``csrc/nms_graph.cu`` runs only on the GPU.  Here a
pure-torch emulation of its order -- tiles of 32 rows walked in order, four
a step, each tile's candidates swept against its diagonal word to the
tile's fixpoint, the columns of this step and the last taken by the
resolver, earlier ones pulled 32 at a time for the next step -- is held
to the sweep twin ``resolve_keep_reference`` and, through the scatter back
to the original order, to the JAX package's ``nms_mask`` (vmapped, XLA
graph build).  Keep-sets must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.ops.nms import nms_mask as jnms_mask
from nerf_rpn_tpu_torch import kernels
from nerf_rpn_tpu_torch.ops.nms import nms_mask, sort_problems
from nerf_rpn_tpu_torch.ops.nms_graph import (
    WORD,
    aabb_suppression_graph_reference,
    resolve_fixpoint,
    resolve_keep,
    resolve_keep_reference,
)


def emulate_resolve(graph: torch.Tensor, svalid: torch.Tensor, span: int = 4) -> torch.Tensor:
    """The resolve kernel's order, one problem and one step of ``span``
    tiles at a time."""
    p, np_, _ = graph.shape
    g = graph.to(torch.int64) & 0xFFFFFFFF
    bits = torch.ones((), dtype=torch.int64) << torch.arange(WORD, dtype=torch.int64)
    alive = torch.zeros((p, np_), dtype=torch.bool)
    for q in range(p):
        valid_rows = svalid[q].nonzero()
        tiles = 0 if len(valid_rows) == 0 else int(valid_rows[-1]) // WORD + 1
        dead = ~svalid[q]
        alive_words = []
        for step in range(-(-tiles // span)):
            first = span * step
            # resolver: its tiles in order; columns from the previous
            # step's first on, then sweeps of the diagonal word
            for t in range(first, min(first + span, tiles)):
                rows = slice(WORD * t, WORD * (t + 1))
                hit = torch.zeros(WORD, dtype=torch.bool)
                for c in range(max(first - span, 0), t):
                    hit |= (g[q, rows, c] & alive_words[c]) != 0
                cand = ~dead[rows] & ~hit
                diag = g[q, rows, t]
                a = cand
                while True:
                    word = int((a.to(torch.int64) * bits).sum())
                    nxt = cand & ((diag & word) == 0)
                    if torch.equal(nxt, a):
                        break
                    a = nxt
                alive[q, rows] = a
                alive_words.append(int((a.to(torch.int64) * bits).sum()))
            # pullers (the same step): the next step's rows against columns
            # 0 .. first-1, 32 at a time
            nxt_rows = slice(WORD * (first + span), WORD * min(first + 2 * span, tiles))
            for block in range(0, first, 32):
                for c in range(block, min(block + 32, first)):
                    dead[nxt_rows] |= (g[q, nxt_rows, c] & alive_words[c]) != 0
    return alive


def _boxes(rng, shape, span=40.0, size=(5.0, 25.0)):
    lo = rng.uniform(0, span, (*shape, 3))
    return np.concatenate([lo, lo + rng.uniform(*size, (*shape, 3))], -1).astype(np.float32)


def _check_all_paths(boxes, scores, valid, thresh):
    """Emulation == sweep twin in the sorted order; nms_mask (CPU) and the
    emulation's keep-set == JAX nms_mask.  Returns the keep-set."""
    tb, ts, tv = torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid)
    order, sboxes, svalid = sort_problems(tb, ts, tv)
    graph = aabb_suppression_graph_reference(sboxes, thresh)
    emulated = emulate_resolve(graph, svalid)
    assert torch.equal(emulated, resolve_keep_reference(graph, svalid))
    keep = torch.zeros_like(tv)
    keep.scatter_(1, order, emulated[:, :tv.shape[1]])
    want = jax.vmap(lambda b, s, v: jnms_mask(b, s, v, thresh))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want))
    assert torch.equal(nms_mask(tb, ts, tv, thresh), keep)
    return keep.numpy()


@pytest.mark.parametrize("n,thresh", [(300, 0.3), (700, 0.1), (520, 0.5)])
def test_emulated_resolve_matches_sweep_twin_and_jax(n, thresh):
    rng = np.random.default_rng(20 + n)
    p = 3
    boxes = _boxes(rng, (p, n))
    scores = (rng.integers(0, 25, (p, n)) / 25.0).astype(np.float32)  # ties
    valid = rng.random((p, n)) > 0.2
    keep = _check_all_paths(boxes, scores, valid, thresh)
    assert 0 < keep.sum() < valid.sum()  # something was suppressed


def _chain(n):
    """n unit boxes along x, each overlapping only the next (IoU 1/3 > 0.3;
    the one after next only touches): greedy keeps every other box, and the
    fixpoint needs ~n sweeps."""
    x = 0.5 * np.arange(n, dtype=np.float32)
    boxes = np.zeros((1, n, 6), np.float32)
    boxes[0, :, 0], boxes[0, :, 3] = x, x + 1.0
    boxes[0, :, 4:6] = 1.0
    scores = (1.0 - np.arange(n) / n).astype(np.float32)[None]
    return boxes, scores, np.ones((1, n), bool)


@pytest.mark.parametrize("n", [256, 512])
def test_depth_n_chain(n):
    boxes, scores, valid = _chain(n)
    keep = _check_all_paths(boxes, scores, valid, 0.3)
    np.testing.assert_array_equal(keep[0], np.arange(n) % 2 == 0)
    # the twin needs a sweep per link of the chain
    _, sboxes, svalid = sort_problems(*(torch.from_numpy(a) for a in (boxes, scores, valid)))
    _, sweeps = resolve_fixpoint(aabb_suppression_graph_reference(sboxes, 0.3), svalid)
    assert sweeps >= n


def _dense(rng, p, n):
    return _boxes(rng, (p, n), span=30.0, size=(5.0, 25.0))


@pytest.mark.parametrize("case", ["valid_counts", "all_invalid", "no_overlaps", "tied_scores"])
def test_resolve_edge_cases(case):
    rng = np.random.default_rng(7)
    p, n = 4, 300
    boxes = _dense(rng, p, n)
    scores = rng.random((p, n)).astype(np.float32)
    valid = np.ones((p, n), bool)
    if case == "valid_counts":  # a different number of valid boxes per problem
        for q, count in enumerate((300, 151, 33, 0)):
            valid[q, rng.permutation(n)[count:]] = False
    elif case == "all_invalid":
        valid[:] = False
    elif case == "no_overlaps":  # disjoint unit cubes on a grid
        idx = np.arange(n)
        lo = np.stack([2.0 * (idx % 10), 2.0 * (idx // 10 % 10), 2.0 * (idx // 100)], -1)
        boxes = np.broadcast_to(np.concatenate([lo, lo + 1.0], -1), (p, n, 6)).astype(np.float32)
        valid = rng.random((p, n)) > 0.3
    else:  # every score equal, or two levels: the stable order decides
        scores[:2] = 0.5
        scores[2:] = np.where(rng.random((2, n)) > 0.5, 0.75, 0.25)
    keep = _check_all_paths(boxes, scores, valid, 0.3)
    assert not keep[~valid].any()
    if case == "all_invalid":
        assert not keep.any()
    if case == "no_overlaps":
        np.testing.assert_array_equal(keep, valid)
    if case in ("valid_counts", "tied_scores"):
        assert 0 < keep.sum() < valid.sum()


def test_resolve_cpu_path_is_the_twin_and_launches_nothing():
    rng = np.random.default_rng(8)
    tb = torch.from_numpy(_dense(rng, 2, 200))
    tv = torch.from_numpy(rng.random((2, 200)) > 0.1)
    _, sboxes, svalid = sort_problems(tb, torch.from_numpy(rng.random((2, 200))), tv)
    graph = aabb_suppression_graph_reference(sboxes, 0.3)
    before = kernels.counts()["nms_resolve"]
    assert torch.equal(resolve_keep(graph, svalid), resolve_keep_reference(graph, svalid))
    assert kernels.counts()["nms_resolve"] == before
