"""Torch port: the FCOS eval slice (swin_t, 64^3, f32) vs JAX, and ``run_fcos`` on the CPU.

One set of JAX ``FCOSOverNeRF`` params (init + noise on every leaf) drives
both packages through ``weights.from_jax_params``, with ``num_convs`` 1
(AABBs) and 2 (OBBs, ``--norm_reg_targets --centerness_on_reg``):

(a) ``weights.py`` carries the ``fcos_head`` tree to the port's names and
    back unchanged;
(b) the eval step's flattened per-level cls, reg (x stride) and ctr
    outputs and the voxel scores within 1e-4 (f32 through 12 Swin blocks,
    the FPN and the towers in another order);
(c) ``propose`` fed the SAME head outputs: the keep-set (``valid``) and
    ``level_idx`` exact, boxes and scores within f32 tolerance.

Then ``run_fcos --device cpu`` trains one epoch on synthetic 32^3 OBB
scenes and evaluates from ``model_best`` with ``--output_proposals
--save_level_index --output_voxel_scores``; the files are checked.  The
CLI run takes ``resnet_tiny``, whose levels sit at the Swin's strides:
the CLI's plumbing does not depend on the backbone, and the Swin FCOS
step is held to JAX's above and in ``test_torch_fcos_train_step.py``.  The
JAX eval step takes its plain (non-Pallas) attention on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.models.fcos import FCOSConfig as JFCOSConfig
from nerf_rpn_tpu.models.heads import FCOSHead3D as JFCOSHead3D
from nerf_rpn_tpu.models.nerf_rpn import FCOSOverNeRF as JFCOSOverNeRF
from nerf_rpn_tpu.train.state import TrainState as JTrainState
from nerf_rpn_tpu.train.steps import make_fcos_eval_step as jax_eval_step
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.cli import run_fcos
from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_dataset
from nerf_rpn_tpu_torch.models.fcos import FCOSConfig
from nerf_rpn_tpu_torch.models.nerf_rpn import FCOSOverNeRF, init_params
from nerf_rpn_tpu_torch.train.steps import make_fcos_eval_step

SHAPE = (64, 64, 64)
PRE, POST = 600, 300


@pytest.fixture(scope="module", params=[(1, False), (2, True)], ids=["convs1_aabb", "convs2_obb"])
def slice_case(request):
    num_convs, rotated = request.param
    rng = np.random.default_rng(num_convs)
    model = JFCOSOverNeRF(backbone_type="swin_t", num_convs=num_convs, rotated=rotated,
                          norm_reg_targets=True, centerness_on_reg=True)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 32, 4)))["params"]
    params = jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.02, p.shape).astype(np.float32), params)
    kw = dict(rotated=rotated, pre_nms_top_n=PRE, fpn_post_nms_top_n=POST)
    jstate = JTrainState(step=0, params=params, batch_stats={}, opt_state=None, tx=None)
    jstep = jax_eval_step(model, JFCOSConfig(**kw), SHAPE)
    port = FCOSOverNeRF("swin_t", num_convs=num_convs, rotated=rotated)
    port.load_state_dict(weights.from_jax_params(params), strict=True)
    pstep = make_fcos_eval_step(port.eval(), FCOSConfig(**kw), SHAPE)
    x = np.random.default_rng(10).uniform(0, 1, (1, *SHAPE, 4)).astype(np.float32)
    ori = np.array([[60, 56, 64]], np.int32)  # padded locations masked
    want = jstep.forward(jstate, jnp.asarray(x))
    return dict(params=params, num_convs=num_convs, jstep=jstep, pstep=pstep, x=x, ori=ori,
                want=want)


def test_a_weights_round_trip(slice_case):
    params = slice_case["params"]
    sd = weights.from_jax_params(params)
    assert sd["fcos_head.scales.3.scale"].shape == (1,)
    last_gn = 3 * slice_case["num_convs"] - 2  # the reference's (conv, GN, ReLU) triples
    assert sd[f"fcos_head.bbox_tower.{last_gn}.weight"].shape == (256,)
    back = weights.flatten_tree(weights.to_jax_params(sd))
    flat = weights.flatten_tree(params)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg="/".join(k))


def test_b_head_outputs(slice_case):
    got = slice_case["pstep"].forward(torch.from_numpy(slice_case["x"]))
    want = slice_case["want"]
    for g, w, name in zip(got[:3], want[:3], ("cls", "reg", "ctr")):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * (1 + np.abs(w).max()),
                                   err_msg=name)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_c_propose_on_same_head_outputs(slice_case):
    cls_f, reg_f, ctr_f, _ = slice_case["want"]
    ori = slice_case["ori"]
    want = slice_case["jstep"].propose(cls_f, reg_f, ctr_f, jnp.asarray(ori))
    got = slice_case["pstep"].propose(*(torch.from_numpy(np.array(t))
                                        for t in (cls_f, reg_f, ctr_f)), torch.from_numpy(ori))
    valid = np.asarray(want["valid"])
    assert valid.sum() > 50
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["level_idx"].numpy(), np.asarray(want["level_idx"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-6, atol=1e-7)
    # OBB decode: sqrt / atan2 of the distances, 1e-5 of the grid
    np.testing.assert_allclose(got["boxes"].numpy()[valid], np.asarray(want["boxes"])[valid],
                               rtol=1e-5, atol=1e-5 * SHAPE[0])


def test_run_fcos_train_then_eval_on_cpu(tmp_path):
    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n_train=2, n_val=1, n_test=1, resolution=(32, 32, 32),
                            rotated=True)
    common = ["--backbone_type", "resnet_tiny", "--resolution", "32", "--num_convs", "1",
              "--rotated_bbox", "--norm_reg_targets", "--centerness_on_reg",
              "--center_sampling_radius", "1.5", "--iou_loss_type", "iou",
              "--pre_nms_top_n", "64", "--fpn_post_nms_top_n", "32", "--device", "cpu",
              "--num_workers", "0", "--features_path", data, "--boxes_path", data,
              "--dataset_split", os.path.join(data, "split.npz")]
    logged = run_fcos.main(["--mode", "train", "--num_epochs", "1", "--log_interval", "1",
                            "--batch_size", "1", "--save_path", str(tmp_path / "run"),
                            *common])
    assert len(logged) == 2
    for m in logged:
        assert np.isfinite([m[k] for k in ("loss", "loss_cls", "loss_reg", "loss_centerness",
                                           "grad_norm")]).all() and m["loss"] > 0
        assert m["dropped_positives"] == 0
    for name in ("model_best", "epoch_1", "model_best.args.json"):
        assert (tmp_path / "run" / name).is_file(), name
    ckpt = torch.load(tmp_path / "run" / "model_best", weights_only=True)
    assert "head.scales.0.scale" in ckpt["fcos_state_dict"]
    out = tmp_path / "out"
    recalls, aps = run_fcos.main([
        "--mode", "eval", "--checkpoint", str(tmp_path / "run" / "model_best"),
        "--save_path", str(out), "--output_proposals", "--save_level_index",
        "--output_voxel_scores", *common])
    assert np.isfinite(recalls).all() and np.isfinite(aps).all()
    assert (out / "eval.json").is_file()
    with np.load(out / "proposals" / "synth003.npz") as z:
        assert z["proposal"].shape == (32, 7) and z["score"].shape == (32,)
        assert set(z["level_indices"].tolist()) <= {0, 1, 2, 3}
    with np.load(out / "voxel_scores" / "synth003.npz") as z:
        assert sorted(z.files) == ["0", "1", "2", "3"] and z["0"].shape == (8, 8, 8)


@pytest.mark.parametrize("argv", [["--gpus", "0,1"], ["--wandb"]])
def test_run_fcos_refuses_unported_options(argv):
    """``--wandb`` is refused; ``--gpus`` names CUDA devices, which this
    CPU-only machine lacks (``--mode eval`` runs on the first of them)."""
    if argv[0] == "--gpus":
        with pytest.raises(RuntimeError, match="cuda"):
            run_fcos.main(["--mode", "eval", "--backbone_type", "swin_t", *argv])
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_fcos.main(["--mode", "eval", "--device", "cpu", "--backbone_type", "swin_t",
                       *argv])


@pytest.mark.parametrize("flag", ["--output_all", "--load_backbone_only", "--conv_at_start"])
def test_run_fcos_accepts_the_rest_of_the_drivers_flags(flag):
    args = run_fcos.parse_args(["--mode", "eval", "--device", "cpu", flag])
    assert getattr(args, flag[2:]) is True


def test_run_fcos_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert run_fcos.parse_args(["--mode", "eval"]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        run_fcos.main(["--mode", "eval", "--backbone_type", "swin_t"])
    with pytest.raises(RuntimeError, match="GPU"):
        run_fcos.main(["--mode", "benchmark", "--backbone_type", "swin_t", "--device", "cpu"])


def test_fcos_head_init_follows_the_flax_initialisers():
    """``init_params`` draws the FCOS head as flax initialises it: convs
    N(0, 0.01), GroupNorm weight 1 and bias 0, scales 1, and the class
    bias -log((1 - p) / p) with p = 0.01; the constants equal JAX's init
    exactly, the conv laws within 5% of 0.01 (sampling error of ~2e5
    draws is under 1%)."""
    model = FCOSOverNeRF("swin_t", num_convs=1, rotated=True)
    init_params(model, torch.Generator().manual_seed(0))
    feats = [jnp.zeros((1, 2, 2, 2, 256))] * 4
    jhead = JFCOSHead3D(in_channels=256, num_convs=1, rotate=True).init(
        jax.random.PRNGKey(0), feats)["params"]
    want = weights.from_jax_params({"fcos_head": jhead})
    got = {k: v for k, v in model.state_dict().items() if k.startswith("fcos_head.")}
    assert set(got) == set(want)
    for name, w in want.items():
        if w.dim() == 5:
            assert abs(got[name].std().item() - 0.01) < 5e-4, name
            assert abs(w.std().item() - 0.01) < 5e-4, name
            assert abs(got[name].mean().item()) < 5e-4, name
        else:
            torch.testing.assert_close(got[name], w, rtol=0, atol=0, msg=name)
    assert got["fcos_head.cls_logits.bias"].item() == pytest.approx(-np.log(99.0), rel=1e-6)
