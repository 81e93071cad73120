"""Torch port: the OBB anchor-RPN eval slice (rotated swin_t, 64^3, f32) vs JAX.

One set of JAX params of a rotated model (init + noise on every leaf; the
head predicts 8 midpoint-offset deltas an anchor) drives both packages,
carried across by ``weights.from_jax_params``:

(a) ``propose`` fed the SAME head outputs: keep-set (``valid``) and
    ``level_idx`` exact, boxes and scores within 1e-6 (relative).  The
    decode takes an OBB's angle from the first edge of a quad, so a thin
    box turns an ulp of a coordinate into ~1e-5 of its angle and ~1e-4 of
    its width.  XLA's fused arithmetic in the jitted step is such an ulp:
    the same JAX step run op by op (``jax.disable_jit``) differs from the
    jitted one by 8.7e-5 on one row here.  So boxes are held within 1e-6 to
    the op-by-op run everywhere, and to the jitted run on every row where
    the two JAX runs agree within that tolerance;
(b) the whole eval step: head outputs within 1e-4;
(c) the port's CLI ``--mode eval --rotated_bbox --weights`` on a synthetic
    OBB dataset gives the same Recall@25/50 and AP@25/50 as the JAX eval
    step, scored by the JAX package's report.

The JAX eval step takes its plain (non-Pallas) attention on the CPU, and
its rotated NMS gates and compacts its pairs (``pair_budget=8``).
"""

import argparse
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.cli import common
from nerf_rpn_tpu.data.datasets import batch_iterator
from nerf_rpn_tpu.data.synthetic import write_synthetic_dataset
from nerf_rpn_tpu.models.nerf_rpn import NeRFRPN as JNeRFRPN
from nerf_rpn_tpu.models.rpn import RPNConfig as JRPNConfig
from nerf_rpn_tpu.train.state import TrainState
from nerf_rpn_tpu.train.steps import make_rpn_eval_step as jax_eval_step
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.cli import run_rpn
from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN
from nerf_rpn_tpu_torch.models.rpn import RPNConfig
from nerf_rpn_tpu_torch.train.steps import make_rpn_eval_step

SHAPE = (64, 64, 64)
PRE, POST = 600, 300


@pytest.fixture(scope="module")
def jax_side():
    rng = np.random.default_rng(0)
    model = JNeRFRPN(backbone_type="swin_t", conv_depth=2, rotated=True)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 32, 4)))["params"]
    params = jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.02, p.shape).astype(np.float32),
        params)
    # moderate head outputs, as in the AABB slice: scores off the sigmoid's
    # saturation and boxes near their anchors
    params["rpn_head"]["cls_logits"]["kernel"] *= 0.05
    params["rpn_head"]["bbox_pred"]["kernel"] *= 0.05
    state = TrainState(step=0, params=params, batch_stats={}, opt_state=None, tx=None)
    cfg = JRPNConfig(rotated=True, pre_nms_top_n=PRE, post_nms_top_n=POST)
    return params, state, jax_eval_step(model, cfg, SHAPE)


@pytest.fixture(scope="module")
def port_step(jax_side):
    model = NeRFRPN("swin_t", conv_depth=2, rotated=True)
    model.load_state_dict(weights.from_jax_params(jax_side[0]), strict=True)
    cfg = RPNConfig(rotated=True, pre_nms_top_n=PRE, post_nms_top_n=POST)
    return make_rpn_eval_step(model.eval(), cfg, SHAPE)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (1, *SHAPE, 4)).astype(np.float32)
    return x, np.array([[60, 56, 64]], np.int32)  # padded anchors masked


@pytest.fixture(scope="module")
def jax_out(jax_side, scene):
    _, state, step = jax_side
    x, ori = scene
    _, obj, dl, _ = step.forward(state, jnp.asarray(x))
    return obj, dl, step.propose(obj, dl, jnp.asarray(ori))


def test_rotated_head_weights_round_trip(jax_side):
    params = jax_side[0]
    sd = weights.from_jax_params(params)
    # 8 deltas an anchor, in the JAX package's anchor-major channel order
    assert sd["rpn_head.bbox_pred.weight"].shape == (13 * 8, 256, 1, 1, 1)
    np.testing.assert_array_equal(
        sd["rpn_head.bbox_pred.weight"][:, :, 0, 0, 0].numpy(),
        params["rpn_head"]["bbox_pred"]["kernel"][0, 0, 0].T)
    back = weights.flatten_tree(weights.to_jax_params(sd))
    want = weights.flatten_tree(params)
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg="/".join(k))
    with pytest.raises(RuntimeError):  # an AABB head cannot take them
        NeRFRPN("swin_t", conv_depth=2).load_state_dict(sd, strict=True)


def test_a_propose_on_same_head_outputs(jax_side, port_step, jax_out, scene):
    obj, dl, want = jax_out
    assert dl[0].shape[-1] == 13 * 8
    with jax.disable_jit():
        op_by_op = jax_side[2].propose(obj, dl, jnp.asarray(scene[1]))
    got = port_step.propose([torch.from_numpy(np.array(o)) for o in obj],
                            [torch.from_numpy(np.array(d)) for d in dl],
                            torch.from_numpy(scene[1]))
    valid = np.asarray(want["valid"])
    assert valid.any() and got["boxes"].shape == (1, POST, 7)
    for ref in (want, op_by_op):
        np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(ref["valid"]))
        np.testing.assert_array_equal(got["level_idx"].numpy(), np.asarray(ref["level_idx"]))
        np.testing.assert_allclose(got["scores"].numpy(), np.asarray(ref["scores"]),
                                   rtol=1e-6, atol=1e-6)
    # f32 decode (atan2, sin, cos, exp): 1e-6 relative to the largest
    # coordinate
    tol = dict(rtol=1e-6, atol=1e-6 * SHAPE[0])
    boxes, jit_boxes = got["boxes"].numpy()[0], np.asarray(want["boxes"])[0]
    eager_boxes = np.asarray(op_by_op["boxes"])[0]
    np.testing.assert_allclose(boxes, eager_boxes, **tol)
    jax_agrees = np.all(np.isclose(jit_boxes, eager_boxes, **tol), axis=-1)
    assert jax_agrees.sum() >= POST - 3
    np.testing.assert_allclose(boxes[jax_agrees], jit_boxes[jax_agrees], **tol)


def test_b_whole_eval_step_head_outputs(port_step, jax_out, scene):
    obj, dl, _ = jax_out
    _, tobj, tdl, _ = port_step.forward(torch.from_numpy(scene[0]))
    for g, w in zip(tobj + tdl, list(obj) + list(dl)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    got = port_step.propose(tobj, tdl, torch.from_numpy(scene[1]))
    assert got["boxes"].shape == (1, POST, 7) and got["valid"].any()


def test_c_cli_eval_metrics_match_jax(jax_side, tmp_path):
    params, state, step = jax_side
    data = tmp_path / "data"
    write_synthetic_dataset(str(data), n_train=0, n_val=0, n_test=3,
                            resolution=SHAPE, rotated=True, seed=3)
    wpath = tmp_path / "w.npz"
    weights.save_npz(str(wpath), params)
    port_dir = tmp_path / "port"
    argv = [
        "--mode", "eval", "--backbone_type", "swin_t", "--rpn_head_conv_depth", "2",
        "--rotated_bbox", "--resolution", str(SHAPE[0]), "--pad_multiple", "32",
        "--rpn_pre_nms_top_n_test", str(PRE), "--rpn_post_nms_top_n_test", str(POST),
        "--features_path", str(data), "--boxes_path", str(data),
        "--dataset_split", str(data / "split.npz"), "--save_path", str(port_dir),
        "--weights", str(wpath), "--device", "cpu", "--num_workers", "0",
        "--output_proposals"]
    recalls, aps = run_rpn.main(argv)
    files = sorted((port_dir / "proposals").glob("*.npz"))
    assert len(files) == 3
    with np.load(files[0]) as z:
        assert z["proposal"].shape[1] == 7 and len(z["proposal"]) == len(z["score"]) > 0

    # the JAX eval step over the same batches, scored by the JAX report
    _, _, ds = common.build_datasets(run_rpn.parse_args(argv), "eval", augment=False)
    props, scores, gts = [], [], []
    for b in batch_iterator(ds, 1, pad_multiple=32, fixed_shape=SHAPE, box_dim=7):
        out = step(state, {"grids": jnp.asarray(b["grids"]),
                           "ori_sizes": jnp.asarray(b["ori_sizes"])})
        p, s, _ = common.unmask_proposals(out, 7)
        props += p
        scores += s
        gts += [b["gt_boxes"][0][b["gt_mask"][0]]]
    assert all(g.shape[1] == 7 and len(g) for g in gts)
    jax_dir = tmp_path / "jax"
    ns = argparse.Namespace(save_path=str(jax_dir), top_k=None)
    common.report_metrics(props, scores, gts, ns, logging.getLogger("jax_ref"), POST)

    got = json.loads((port_dir / "eval.json").read_text())
    want = json.loads((jax_dir / "eval.json").read_text())
    for key in ("recall_25_top_300", "recall_50_top_300"):
        assert got[key]["ar"] == want[key]["ar"], key
    for key in ("ap_25", "ap_50"):
        assert got[key]["ap"] == want[key]["ap"], key
    assert recalls[0] == want["recall_50_top_300"]["ar"]
    assert aps[0] == want["ap_50"]["ap"]
