"""Torch port: the RCNN eval slice -- ``make_rcnn_eval_step`` then
``make_rcnn_filter_step`` and the driver's metrics -- against the JAX
package's on the same weights and batch.

Cases: the features mode with AABB RoIs (max pooling, the conv tower,
flatten), with OBB RoIs (align, mean), and ``--fine_tune`` on
``resnet_tiny`` at 32^3 (the backbone in eval mode: running statistics
that are not 0 / 1).  Batch 2, f32.  Compared: the scores within 1e-5 of
their largest entry, the refined boxes within 1e-4 of each row's largest
entry (the decode's exp turns the head's f32 rounding, ~1e-6 of its
deltas' scale after the fine-tune backbone, into 1.1e-5 of a box whose
size delta is ~9), the labels exactly; the filter
on JAX's eval outputs in both packages, whose keep-sets and orders must be
equal and boxes within 1e-5; then the port's own chain (its eval outputs
through its filter) against JAX's: the same keep-sets, and the
classification precision / accuracy / precision@100 and AP@25 / AP@50 of
the driver (``cli/run_rpn_detect.py``) within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import FrozenDict

from nerf_rpn_tpu.models import detector as jdet
from nerf_rpn_tpu.models.nerf_rpn import build_backbone as jbuild
from nerf_rpn_tpu.train.state import TrainState as JState
from nerf_rpn_tpu.train.state import make_optimizer
from nerf_rpn_tpu.train.steps import make_rcnn_eval_step as jax_eval_step
from nerf_rpn_tpu.train.steps import make_rcnn_filter_step as jax_filter_step
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.evaluation.metrics import (evaluate_box_proposals_ap,
                                                    evaluate_classification)
from nerf_rpn_tpu_torch.models import detector as tdet
from nerf_rpn_tpu_torch.models.nerf_rpn import build_backbone
from nerf_rpn_tpu_torch.train.steps import make_rcnn_eval_step, make_rcnn_filter_step

SCALES = (4, 8, 16, 32)
FILTER = (0.5, 0.3, 20)   # score threshold, NMS IoU, number cap
CASES = {
    # (rotated, fine_tune, pool mode, conv tower, flatten, channels)
    "features_aabb": (False, False, "max", True, True, 16),
    "features_obb": (True, False, "avg", False, False, 16),
    "finetune_resnet_tiny": (False, True, "max", False, True, 32),
}


def close(got, want, tol=1e-5):
    got = np.asarray(got.float() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def close_rows(got, want, tol):
    got = np.asarray(got.float(), np.float64)
    want = np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).max(-1, keepdims=True), 1.0)
    assert np.all(np.abs(got - want) <= tol * scale), np.abs(got - want).max()


def _batch(rng, rotated, fine_tune, b=2, r=48):
    if rotated:
        gt = np.concatenate([rng.uniform(8, 24, (b, 3, 3)), rng.uniform(4, 10, (b, 3, 3)),
                             rng.uniform(-1.5, 1.5, (b, 3, 1))], -1).astype(np.float32)
        rois = np.concatenate([rng.uniform(2, 30, (b, r, 3)), rng.uniform(2, 10, (b, r, 3)),
                               rng.uniform(-1.5, 1.5, (b, r, 1))], -1).astype(np.float32)
    else:
        lo = rng.uniform(2, 20, (b, 3, 3))
        gt = np.concatenate([lo, lo + rng.uniform(4, 10, (b, 3, 3))], -1).astype(np.float32)
        lo = rng.uniform(0, 26, (b, r, 3))
        rois = np.concatenate([lo, lo + rng.uniform(2, 10, (b, r, 3))], -1).astype(np.float32)
    rois[:, :12] = np.repeat(gt, 4, 1) + rng.uniform(-0.8, 0.8, (b, 12, gt.shape[-1]))
    gt_mask = np.ones((b, 3), bool)
    gt_mask[1, 2] = False
    valid = np.ones((b, r), bool)
    valid[1, -8:] = False
    batch = dict(rois=rois, roi_levels=rng.integers(0, 4, (b, r)).astype(np.int32),
                 roi_valid=valid, gt_boxes=gt, gt_mask=gt_mask)
    if fine_tune:
        grids = rng.uniform(0, 1, (b, 32, 32, 32, 4)).astype(np.float32)
        grids[1, 4:20, 8:28, 6:30, 3] += 2.0
        batch["grids"] = grids
    else:
        batch["features"] = [rng.standard_normal((b, s, s, s, 16)).astype(np.float32)
                             for s in (8, 4, 2, 1)]
    return batch


def _metrics(out, keep, order, boxes, batch, d):
    """The driver's per-scene unmasking and report (``Trainer.eval``)."""
    scores, labels, refined, fscores, gts = [], [], [], [], []
    for i in range(len(keep)):
        v = out["valid"][i]
        scores.append(out["scores"][i][v][:, 1])
        labels.append(out["labels"][i][v].astype(np.int32))
        ranked = order[i][keep[i][order[i]]]
        refined.append(boxes[i][ranked][:, :d])
        fscores.append(out["scores"][i][ranked][:, 1])
        gts.append(batch["gt_boxes"][i][batch["gt_mask"][i]])
    return dict(evaluate_classification(scores, labels, 0.5),
                ap25=evaluate_box_proposals_ap(refined, fscores, gts, 0.25)["ap"],
                ap50=evaluate_box_proposals_ap(refined, fscores, gts, 0.5)["ap"])


@pytest.mark.parametrize("case", list(CASES))
def test_eval_and_filter_slice_matches_jax(case):
    rotated, fine_tune, pool, add, flatten, c = CASES[case]
    rng = np.random.default_rng(11)
    batch = _batch(rng, rotated, fine_tune)
    kw = dict(rotated=rotated, output_size=(2, 2, 2), pool_mode=pool, fg_threshold=0.3)
    jcfg, tcfg = jdet.RCNNConfig(**kw), tdet.RCNNConfig(**kw)
    jhead = jdet.RCNNHead(in_channels=c, rotated=rotated, add_conv_layers=add, flatten=flatten)
    noise = lambda t: jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32), t)
    params = noise(jhead.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, 2, c)))["params"])
    backbone, stats = None, FrozenDict()
    if fine_tune:
        backbone = jbuild("resnet_tiny", 32)
        bv = backbone.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 32, 4)))
        params = {"backbone": noise(bv["params"]), "head": params}
        stats = jax.tree.map(lambda s: np.asarray(s) + rng.uniform(0.1, 0.3, s.shape).astype(
            np.float32), bv["batch_stats"])
    tx, _ = make_optimizer(1e-3, 10)
    state = JState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                   opt_state=tx.init(params), tx=tx)
    jb = {k: [jnp.asarray(f) for f in v] if k == "features" else jnp.asarray(v)
          for k, v in batch.items()}
    jout = jax.device_get(jax_eval_step(jhead, jcfg, SCALES, backbone)(state, jb))
    mesh = np.full((2, 3), 32.0, np.float32)
    jfilter = jax_filter_step(jcfg, *FILTER)
    jboxes, jkeep, jorder = map(np.asarray, jfilter(*map(jnp.asarray, (
        jout["refined_boxes"], jout["scores"], jout["valid"], mesh))))

    port = tdet.RCNNDetector(tdet.RCNNHead(c, 2, rotated, add, flatten, (2, 2, 2)),
                             build_backbone("resnet_tiny", 32) if fine_tune else None)
    port.load_state_dict(weights.rcnn_from_jax_params(
        params, stats if fine_tune else None, port.backbone), strict=True)
    tb = {k: [torch.from_numpy(f) for f in v] if k == "features" else torch.from_numpy(v)
          for k, v in batch.items()}
    tout = make_rcnn_eval_step(port, tcfg, SCALES)(tb)
    close(tout["scores"], jout["scores"])
    close_rows(tout["refined_boxes"], jout["refined_boxes"], 1e-4)
    np.testing.assert_array_equal(tout["labels"].numpy(), jout["labels"])
    np.testing.assert_array_equal(tout["valid"].numpy(), jout["valid"])
    assert 0 < jout["labels"].sum() < jout["valid"].sum()

    # the filter on the same inputs: equal keep-sets and orders
    tfilter = make_rcnn_filter_step(tcfg, *FILTER)
    tboxes, tkeep, torder = tfilter(*map(torch.from_numpy, (
        np.asarray(jout["refined_boxes"]), np.asarray(jout["scores"]), jout["valid"], mesh)))
    close(tboxes, jboxes)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    np.testing.assert_array_equal(torder.numpy(), jorder)
    assert 0 < jkeep.sum() < jout["valid"].sum()

    # the port's own chain and the driver's metrics
    pboxes, pkeep, porder = tfilter(tout["refined_boxes"], tout["scores"], tout["valid"],
                                    torch.from_numpy(mesh))
    np.testing.assert_array_equal(pkeep.numpy(), jkeep)
    pout = {k: v.numpy() for k, v in tout.items()}
    want = _metrics(jout, jkeep, jorder, jboxes, batch, jcfg.box_dim)
    got = _metrics(pout, pkeep.numpy(), porder.numpy(), pboxes.numpy(), batch, jcfg.box_dim)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
