"""Torch port: the anchor-RPN eval slice (swin_t, 64^3, f32) vs JAX.

One set of JAX params (init + noise on every leaf) drives both packages:

(a) ``propose`` fed the SAME head outputs: keep-set (``valid``),
    ``level_idx`` exact, boxes and scores within 1e-6 (relative);
(b) the whole eval step: head outputs within 1e-4, top-300 boxes within
    1e-3 (relative);
(c) the port's CLI ``--mode eval --weights`` on a synthetic dataset
    gives the same Recall@25/50 and AP@25/50 as the JAX eval step.

The JAX eval step takes its plain (non-Pallas) attention on the CPU.
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
SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_side():
    rng = np.random.default_rng(0)
    model = JNeRFRPN(backbone_type="swin_t", conv_depth=2)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 32, 4)))["params"]
    params = jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.02, p.shape).astype(np.float32),
        params)
    # moderate head outputs: logits |l| < ~1.5 keep the scores off the
    # sigmoid's f32 saturation (where runs of them tie at 1.0), and small
    # deltas keep the boxes anchor-like instead of exp-clamped boxes that
    # fill the grid (whose IoUs crowd the NMS threshold)
    params["rpn_head"]["cls_logits"]["kernel"] *= 0.05
    params["rpn_head"]["bbox_pred"]["kernel"] *= 0.05
    state = TrainState(step=0, params=params, batch_stats={}, opt_state=None, tx=None)
    step = jax_eval_step(model, JRPNConfig(pre_nms_top_n=PRE, post_nms_top_n=POST), SHAPE)
    return params, state, step


@pytest.fixture(scope="module")
def port_step(jax_side):
    params = jax_side[0]
    model = NeRFRPN("swin_t", conv_depth=2)
    model.load_state_dict(weights.from_jax_params(params), strict=True)
    return make_rpn_eval_step(model.eval(), RPNConfig(pre_nms_top_n=PRE, post_nms_top_n=POST),
                              SHAPE)


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


def test_a_propose_on_same_head_outputs(port_step, jax_out, scene):
    obj, dl, want = jax_out
    got = port_step.propose([torch.from_numpy(np.array(o)) for o in obj],
                            [torch.from_numpy(np.array(d)) for d in dl],
                            torch.from_numpy(scene[1]))
    valid = np.asarray(want["valid"])
    assert valid.any()
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["level_idx"].numpy(), np.asarray(want["level_idx"]))
    # f32 decode: 1e-6 relative to the largest coordinate (an exp ulp)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               rtol=1e-6, atol=1e-6 * SHAPE[0])
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-6, atol=1e-6)


def test_b_whole_eval_step(port_step, jax_out, scene):
    obj, dl, want = jax_out
    _, tobj, tdl, _ = port_step.forward(torch.from_numpy(scene[0]))
    for g, w in zip(tobj + tdl, list(obj) + list(dl)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    got = port_step.propose(tobj, tdl, torch.from_numpy(scene[1]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    # scores differ by ~1e-6 here, so two proposals whose scores are that
    # close may trade ranks: each JAX row must have a port row with a score
    # within SCORE_TOL and a box within 1e-3 (relative); rows that close to
    # the cut-off score may trade places with rows below it
    ws, wb = np.asarray(want["scores"])[0], np.asarray(want["boxes"])[0]
    gs, gb = got["scores"].numpy()[0], got["boxes"].numpy()[0]
    np.testing.assert_allclose(gs, ws, rtol=0, atol=SCORE_TOL)
    for i in np.flatnonzero(ws > ws.min() + SCORE_TOL):
        near = np.abs(gs - ws[i]) <= SCORE_TOL
        close = np.all(np.abs(gb[near] - wb[i]) <= 1e-3 + 1e-3 * np.abs(wb[i]), axis=1)
        assert close.any(), (i, ws[i], wb[i])


def test_c_cli_eval_metrics_match_jax(jax_side, tmp_path):
    params, state, step = jax_side
    data = tmp_path / "data"
    write_synthetic_dataset(str(data), n_train=0, n_val=0, n_test=3,
                            resolution=SHAPE, seed=3)
    wpath = tmp_path / "w.npz"
    weights.save_npz(str(wpath), params)
    port_dir = tmp_path / "port"
    argv = [
        "--mode", "eval", "--backbone_type", "swin_t", "--rpn_head_conv_depth", "2",
        "--resolution", str(SHAPE[0]), "--pad_multiple", "32",
        "--rpn_pre_nms_top_n_test", str(PRE), "--rpn_post_nms_top_n_test", str(POST),
        "--features_path", str(data), "--boxes_path", str(data),
        "--dataset_split", str(data / "split.npz"), "--save_path", str(port_dir),
        "--weights", str(wpath), "--device", "cpu", "--num_workers", "0",
        "--output_proposals"]
    recalls, aps = run_rpn.main(argv)
    assert len(list((port_dir / "proposals").glob("*.npz"))) == 3

    # the JAX eval step over the same batches, scored by the same report
    _, _, ds = common.build_datasets(run_rpn.parse_args(argv), "eval", augment=False)
    props, scores, gts = [], [], []
    for b in batch_iterator(ds, 1, pad_multiple=32, fixed_shape=SHAPE):
        out = step(state, {"grids": jnp.asarray(b["grids"]),
                           "ori_sizes": jnp.asarray(b["ori_sizes"])})
        p, s, _ = common.unmask_proposals(out, 6)
        props += p
        scores += s
        gts += [b["gt_boxes"][0][b["gt_mask"][0]]]
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


def test_benchmark_mode_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        run_rpn.main(["--mode", "benchmark", "--backbone_type", "swin_t",
                      "--device", "cpu"])


@pytest.mark.parametrize("argv,exc", [
    (["--backbone_type", "vgg_AF", "--resolution", "32"], ValueError),
    (["--backbone_type", "swin_t", "--reg_loss_type", "iou"], NotImplementedError),
])
def test_cli_rejects_unported_options(argv, exc, tmp_path):
    """On a one-scene dataset: VGG below 160 is refused where the eval
    step is built, the AABB IoU loss where the driver builds its RPN
    config."""
    write_synthetic_dataset(str(tmp_path), n_train=1, n_val=1, n_test=1)
    data = ["--features_path", str(tmp_path), "--boxes_path", str(tmp_path),
            "--dataset_split", str(tmp_path / "split.npz"), "--save_path", str(tmp_path)]
    with pytest.raises(exc):
        run_rpn.main(["--mode", "eval", "--device", "cpu", *data, *argv])
