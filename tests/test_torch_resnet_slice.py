"""Torch port: the ``resnet_tiny`` eval slices (64^3, f32) vs JAX, ``--save_results``
against the JAX driver's writer, and VGG below 160 in both packages.

One set of JAX params (init + noise on every leaf) and ``batch_stats``
(those of one train-mode batch of another grid: not 0 / 1) drives both
packages through ``weights.from_jax_params``:

- the anchor RPN, AABB and OBB (``conv_depth`` 2): the head outputs within
  1e-5 of each level's largest (f32, eval-mode BatchNorm); ``propose`` fed
  the SAME head outputs gives the keep-set and ``level_idx`` exactly, boxes
  and scores within 1e-6 (relative); the whole eval step gives the JAX
  step's keep-set;
- FCOS (``num_convs`` 2, ``--norm_reg_targets --centerness_on_reg``) on
  AABBs: the flattened head outputs within 1e-5 (relative), and
  ``propose`` on the same head outputs exactly as above.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.cli.run_rpn import Trainer as JTrainer
from nerf_rpn_tpu.models.fcos import FCOSConfig as JFCOSConfig
from nerf_rpn_tpu.models.nerf_rpn import FCOSOverNeRF as JFCOSOverNeRF
from nerf_rpn_tpu.models.nerf_rpn import NeRFRPN as JNeRFRPN
from nerf_rpn_tpu.models.rpn import RPNConfig as JRPNConfig
from nerf_rpn_tpu.train.state import TrainState as JTrainState
from nerf_rpn_tpu.train.steps import make_fcos_eval_step as jax_fcos_step
from nerf_rpn_tpu.train.steps import make_rpn_eval_step as jax_rpn_step
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.cli import run_fcos, run_rpn
from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_dataset
from nerf_rpn_tpu_torch.models.fcos import FCOSConfig
from nerf_rpn_tpu_torch.models.nerf_rpn import FCOSOverNeRF, NeRFRPN
from nerf_rpn_tpu_torch.models.rpn import RPNConfig
from nerf_rpn_tpu_torch.train.steps import make_fcos_eval_step, make_rpn_eval_step

SHAPE = (64, 64, 64)
PRE, POST = 600, 300


def _variables(model, seed):
    """Params with noise and the running statistics of one train batch."""
    rng = np.random.default_rng(seed)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 32, 4)))
    params = jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.02, p.shape).astype(np.float32), v["params"])
    other = rng.uniform(0, 1, (2, 32, 32, 32, 4)).astype(np.float32)
    _, mut = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                         jnp.asarray(other), train=True, mutable=["batch_stats"])
    return params, jax.tree.map(np.asarray, mut["batch_stats"])


@pytest.fixture(scope="module")
def scene():
    x = np.random.default_rng(7).uniform(0, 1, (1, *SHAPE, 4)).astype(np.float32)
    return x, np.array([[60, 56, 64]], np.int32)  # padded anchors masked


@pytest.fixture(scope="module", params=[False, True], ids=["aabb", "obb"])
def rpn_case(request, scene):
    rotated = request.param
    model = JNeRFRPN(backbone_type="resnet_tiny", conv_depth=2, rotated=rotated)
    params, stats = _variables(model, 1 + rotated)
    # moderate head outputs (as the Swin slice): no saturated score ties
    params["rpn_head"]["cls_logits"]["kernel"] *= 0.05
    params["rpn_head"]["bbox_pred"]["kernel"] *= 0.05
    kw = dict(rotated=rotated, pre_nms_top_n=PRE, post_nms_top_n=POST)
    jstate = JTrainState(step=0, params=params, batch_stats=stats, opt_state=None, tx=None)
    jstep = jax_rpn_step(model, JRPNConfig(**kw), SHAPE, return_features=True)
    port = NeRFRPN("resnet_tiny", conv_depth=2, rotated=rotated)
    port.load_state_dict(weights.from_jax_params(params, stats, port.backbone), strict=True)
    pstep = make_rpn_eval_step(port.eval(), RPNConfig(**kw), SHAPE, return_features=True)
    x, ori = scene
    _, obj, dl, _ = jstep.forward(jstate, jnp.asarray(x))
    want = jstep(jstate, {"grids": jnp.asarray(x), "ori_sizes": jnp.asarray(ori)})
    return dict(jstep=jstep, pstep=pstep, obj=obj, dl=dl, want=want, rotated=rotated)


def _level_close(got, want, rel):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= rel * np.abs(w).max()


def test_rpn_head_outputs(rpn_case, scene):
    _, obj, dl, _ = rpn_case["pstep"].forward(torch.from_numpy(scene[0]))
    _level_close(obj, rpn_case["obj"], 1e-5)
    _level_close(dl, rpn_case["dl"], 1e-5)


def test_rpn_propose_on_same_head_outputs(rpn_case, scene):
    want = rpn_case["jstep"].propose(rpn_case["obj"], rpn_case["dl"], jnp.asarray(scene[1]))
    got = rpn_case["pstep"].propose([torch.from_numpy(np.array(o)) for o in rpn_case["obj"]],
                                    [torch.from_numpy(np.array(d)) for d in rpn_case["dl"]],
                                    torch.from_numpy(scene[1]))
    valid = np.asarray(want["valid"])
    assert valid.sum() > 20
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["level_idx"].numpy(), np.asarray(want["level_idx"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["boxes"].numpy()[valid], np.asarray(want["boxes"])[valid],
                               rtol=1e-6, atol=(1e-4 if rpn_case["rotated"] else 1e-6) * SHAPE[0])


def test_rpn_whole_eval_step_keep_set(rpn_case, scene):
    got = rpn_case["pstep"](torch.from_numpy(scene[0]), torch.from_numpy(scene[1]))
    want = rpn_case["want"]
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=0, atol=1e-5)
    _level_close(got["features"], want["features"], 1e-5)


def test_fcos_eval_slice(scene):
    model = JFCOSOverNeRF(backbone_type="resnet_tiny", num_convs=2, norm_reg_targets=True,
                          centerness_on_reg=True)
    params, stats = _variables(model, 3)
    kw = dict(pre_nms_top_n=PRE, fpn_post_nms_top_n=POST)
    jstate = JTrainState(step=0, params=params, batch_stats=stats, opt_state=None, tx=None)
    jstep = jax_fcos_step(model, JFCOSConfig(**kw), SHAPE)
    port = FCOSOverNeRF("resnet_tiny", num_convs=2)
    port.load_state_dict(weights.from_jax_params(params, stats, port.backbone), strict=True)
    pstep = make_fcos_eval_step(port.eval(), FCOSConfig(**kw), SHAPE)
    x, ori = scene
    want = jstep.forward(jstate, jnp.asarray(x))
    got = pstep.forward(torch.from_numpy(x))
    _level_close(got[:3], want[:3], 1e-5)
    wp = jstep.propose(*want[:3], jnp.asarray(ori))
    gp = pstep.propose(*(torch.from_numpy(np.array(t)) for t in want[:3]), torch.from_numpy(ori))
    valid = np.asarray(wp["valid"])
    assert valid.sum() > 20
    np.testing.assert_array_equal(gp["valid"].numpy(), valid)
    np.testing.assert_array_equal(gp["level_idx"].numpy(), np.asarray(wp["level_idx"]))
    np.testing.assert_allclose(gp["scores"].numpy(), np.asarray(wp["scores"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(gp["boxes"].numpy()[valid], np.asarray(wp["boxes"])[valid],
                               rtol=1e-6, atol=1e-6 * SHAPE[0])


def test_save_results_writes_the_jax_drivers_files(rpn_case, tmp_path):
    """The same eval output through the JAX driver's ``_save_results`` and
    the port's ``Trainer.save_results``: the same files, keys, dtypes,
    shapes and values."""
    box_dim = 7 if rpn_case["rotated"] else 6
    want_out = {k: np.asarray(v) if not isinstance(v, list) else [np.asarray(t) for t in v]
                for k, v in rpn_case["want"].items()}
    names = ["scene_a"]
    levels = [want_out["level_idx"][0][want_out["valid"][0]]]
    jself = argparse.Namespace(
        args=argparse.Namespace(save_results_path=str(tmp_path / "jax"), save_path=""),
        box_dim=box_dim)
    JTrainer._save_results(jself, names, want_out, levels, 0)
    pself = argparse.Namespace(
        args=argparse.Namespace(save_results_path=str(tmp_path / "port"), save_path=""),
        box_dim=box_dim)
    port_out = {"features": [torch.from_numpy(f) for f in want_out["features"]],
                "boxes": torch.from_numpy(want_out["boxes"]),
                "valid": torch.from_numpy(want_out["valid"])}
    run_rpn.Trainer.save_results(pself, names, port_out, levels)
    for sub in ("features", "proposals"):
        assert os.listdir(tmp_path / "jax" / sub) == os.listdir(tmp_path / "port" / sub)
        with np.load(tmp_path / "jax" / sub / "scene_a.npz", allow_pickle=True) as j, \
                np.load(tmp_path / "port" / sub / "scene_a.npz", allow_pickle=True) as p:
            assert j.files == p.files
            for k in j.files:
                assert j[k].dtype == p[k].dtype and j[k].shape == p[k].shape, (sub, k)
                if j[k].dtype == object:
                    for a, b in zip(j[k], p[k]):
                        assert a.dtype == b.dtype and a.shape == b.shape
                        np.testing.assert_array_equal(a.astype(np.float32),
                                                      b.astype(np.float32))
                else:
                    np.testing.assert_array_equal(j[k], p[k])


def test_vgg_below_160_fails_in_jax_and_raises_in_the_port(tmp_path):
    """``vgg_AF`` at ``--resolution`` 16 has a stride-1 stem: its levels
    are 16^3 ... 2^3 where the anchor tables of strides (4, 8, 16, 32)
    expect 4^3 ... 1^3.  The JAX eval step fails with a broadcast error;
    the port raises a ValueError that says why, in the step and in both
    drivers' eval on a one-scene dataset (``--check_arch`` builds and
    counts the model, as JAX's does)."""
    shape = (16, 16, 16)
    jm = JNeRFRPN(backbone_type="vgg_AF", resolution=16, conv_depth=1)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, *shape, 4))))
    zeros = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), v)
    jstate = JTrainState(step=0, params=zeros["params"], batch_stats=zeros["batch_stats"],
                         opt_state=None, tx=None)
    jstep = jax_rpn_step(jm, JRPNConfig(pre_nms_top_n=64, post_nms_top_n=32), shape)
    with pytest.raises(ValueError, match="broadcast"):
        jstep(jstate, {"grids": jnp.zeros((1, *shape, 4)),
                       "ori_sizes": jnp.asarray([[16, 16, 16]], jnp.int32)})
    with torch.device("meta"):
        port = NeRFRPN("vgg_AF", conv_depth=1, resolution=16)
    with pytest.raises(ValueError, match=r"strides \(1, 2, 4, 8\).*stride-1 stem"):
        make_rpn_eval_step(port, RPNConfig(), shape)
    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n_train=1, n_val=1, n_test=1)
    args = ["--device", "cpu", "--backbone_type", "vgg_AF", "--resolution", "32",
            "--features_path", data, "--boxes_path", data,
            "--dataset_split", os.path.join(data, "split.npz"), "--save_path", str(tmp_path)]
    assert run_rpn.main(["--check_arch", *args]) > 0
    for cli in (run_rpn, run_fcos):
        with pytest.raises(ValueError, match="stride-1 stem"):
            cli.main(["--mode", "eval", *args])
