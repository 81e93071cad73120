"""Torch port: NMS of oriented boxes vs JAX.

``nms_mask`` on (P, N, 7) OBBs -- P = 4 problems of 300 to 600 boxes,
crowded so that many pairs clear the gate -- against the JAX package's
``nms_mask`` run per problem with ``pair_budget=8`` (gated, compacted
clipping) and ``None`` (every pair clipped).  Keep-sets must match exactly.

The graph bits are held to the JAX graph that ``pair_budget=None`` builds
(``pairwise_iou_rotated_3d_soa`` of the score-sorted boxes, strictly above
the threshold, below the diagonal): they must match except at pairs whose
JAX IoU lies within 1e-5 of the threshold, and the test asserts that the
bits that differ are only such pairs.  The keep-set and the graph do not
change with the row chunk of the graph build.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.ops.nms import nms_mask as jnms_mask
from nerf_rpn_tpu.ops.rotated_iou_pairwise import pairwise_iou_rotated_3d_soa as jiou
from nerf_rpn_tpu_torch.ops.nms import nms_mask, obb_suppression_graph, sort_problems
from nerf_rpn_tpu_torch.ops.nms_graph import pack_bits, resolve_keep

THRESH = 0.3
NEAR = 1e-5


def _problem(seed, p, n):
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(0, 40, (p, n, 3))
    dims = rng.uniform(3.0, 15.0, (p, n, 3))
    theta = rng.uniform(-np.pi / 2, np.pi / 2, (p, n, 1))
    boxes = np.concatenate([ctr, dims, theta], -1).astype(np.float32)
    boxes[:, :8] = boxes[:, 8:16]                       # exact duplicates
    # turned copies of rows 24:32, sizes swapped
    boxes[:, 16:24, 3:5] = boxes[:, 24:32, 3:5][..., ::-1]
    boxes[:, 16:24, :3] = boxes[:, 24:32, :3]
    boxes[:, 16:24, 5] = boxes[:, 24:32, 5]
    boxes[:, 16:24, 6] = boxes[:, 24:32, 6] + np.float32(np.pi / 2)
    scores = rng.uniform(0, 1, (p, n)).astype(np.float32)
    scores[:, 40:60] = scores[:, 60:80]                 # ties: the lower index first
    valid = rng.uniform(size=(p, n)) > 0.1
    return boxes, scores, valid


@pytest.mark.parametrize("n", [300, 600])
def test_keep_set_matches_jax(n):
    boxes, scores, valid = _problem(n, 4, n)
    got = nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                   torch.from_numpy(valid), THRESH).numpy()
    assert got.shape == (4, n) and not (got & ~valid).any()
    for budget in (8, None):
        want = np.stack([np.asarray(jnms_mask(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                              jnp.asarray(valid[i]), THRESH,
                                              pair_budget=budget))
                         for i in range(4)])
        np.testing.assert_array_equal(got, want, err_msg=f"pair_budget={budget}")
    assert 0.2 * valid.sum() < got.sum() < 0.9 * valid.sum()


def test_graph_bits_match_jax_off_the_threshold():
    boxes, scores, valid = _problem(7, 4, 450)
    _, sboxes, _ = sort_problems(torch.from_numpy(boxes), torch.from_numpy(scores),
                                 torch.from_numpy(valid))
    stats = {}
    graph = obb_suppression_graph(sboxes, THRESH, stats=stats)
    np_ = sboxes.shape[1]
    assert graph.shape == (4, np_, np_ // 32) and graph.dtype == torch.int32
    below = np.tril(np.ones((np_, np_), bool), -1)
    n_set = 0
    for p in range(4):
        iou = np.asarray(jiou(jnp.asarray(sboxes[p].numpy()), jnp.asarray(sboxes[p].numpy())))
        want = pack_bits(torch.from_numpy((iou > THRESH) & below)).numpy()
        differ = np.unpackbits(np.bitwise_xor(graph[p].numpy(), want).view(np.uint8),
                               axis=-1, bitorder="little").astype(bool)
        near = np.abs(iou - THRESH) <= NEAR
        assert not (differ & ~near).any(), np.argwhere(differ & ~near)[:5]
        n_set += ((iou > THRESH) & below).sum()
    assert n_set > 300
    assert 0 < stats["gated"] < stats["pairs"] and stats["syncs"] == 1


def test_keep_set_and_graph_do_not_depend_on_the_row_chunk():
    boxes, scores, valid = _problem(3, 4, 500)
    _, sboxes, svalid = sort_problems(*(torch.from_numpy(a) for a in (boxes, scores, valid)))
    graphs = [obb_suppression_graph(sboxes, THRESH, row_chunk=c, pair_batch=b)
              for c, b in ((32, 1000), (64, 1 << 17), (512, 1 << 18))]
    assert all(torch.equal(g, graphs[0]) for g in graphs[1:])
    keeps = [resolve_keep(g, svalid) for g in graphs]
    assert all(torch.equal(k, keeps[0]) for k in keeps[1:])
    assert 0 < int(keeps[0].sum()) < int(svalid.sum())
