"""The JAX package's checkpoint formats in the torch port
(``train/checkpoint.py``, ``train/flax_msgpack.py``,
``tools/convert_weights.py``), ``resnet_tiny`` at 32^3 (Swin-T for the
converter), against the JAX package on the CPU.

- flax's ``msgpack_serialize`` of JAX-initialised variables (the anchor RPN
  with AABBs and OBBs, FCOS, the RCNN fine-tune state; ``batch_stats``
  included) reads back bit-exact through ``read_msgpack``, and the port's
  writer packs the read tree to flax's bytes; one tree in flax's chunked
  form (``MAX_CHUNK_SIZE`` lowered in the test) with a bf16 leaf too;
- the drivers' ``--checkpoint x.msgpack`` (and ``--load_backbone_only``,
  ``run_rpn_detect --pretrained``) load those files: the heads' outputs
  within 1e-5 of each level's largest of JAX's forward (the parity tests'
  f32 rule), the RCNN backbone and head likewise;
- an orbax directory of the JAX package's ``save_checkpoint`` raises a
  ``ValueError`` naming its export; that export, run here, gives a
  ``.msgpack`` that the port evaluates to JAX's keep-set;
- a released-layout reference ``.pt`` (head in the reference's anchor
  order, no ``anchor_order`` entry) through the port's ``--checkpoint``
  gives the keep-set that the JAX package gives after its
  ``convert_rpn_checkpoint``;
- ``python -m nerf_rpn_tpu_torch.tools.convert_weights`` writes the bytes
  of the JAX tool on the same ``.pt`` (RPN AABB / OBB, FCOS).
"""

import os
import shlex
import subprocess
import sys

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.models.detector import RCNNHead as JRCNNHead
from nerf_rpn_tpu.models.fcos import FCOSConfig as JFCOSConfig
from nerf_rpn_tpu.models.nerf_rpn import FCOSOverNeRF as JFCOSOverNeRF
from nerf_rpn_tpu.models.nerf_rpn import NeRFRPN as JNeRFRPN
from nerf_rpn_tpu.models.nerf_rpn import build_backbone as jbuild_backbone
from nerf_rpn_tpu.models.rpn import RPNConfig as JRPNConfig
from nerf_rpn_tpu.tools import convert_weights as jconvert
from nerf_rpn_tpu.train.state import TrainState as JTrainState
from nerf_rpn_tpu.train.steps import make_fcos_eval_step as jax_fcos_step
from nerf_rpn_tpu.train.steps import make_rpn_eval_step as jax_rpn_step
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.cli import run_fcos, run_rpn, run_rpn_detect
from nerf_rpn_tpu_torch.models.anchors import DEFAULT_ASPECT_RATIOS, anchor_permutation
from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN
from nerf_rpn_tpu_torch.tools import convert_weights
from nerf_rpn_tpu_torch.train import checkpoint as ckpt_lib
from nerf_rpn_tpu_torch.train import flax_msgpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (32, 32, 32)
PRE, POST = 600, 300
COMMON = ["--device", "cpu", "--backbone_type", "resnet_tiny", "--resolution", "32"]
RPN_ARGS = [*COMMON, "--rpn_head_conv_depth", "1", "--rpn_pre_nms_top_n_test", str(PRE),
            "--rpn_post_nms_top_n_test", str(POST)]
FCOS_ARGS = [*COMMON, "--num_convs", "1", "--norm_reg_targets", "--centerness_on_reg",
             "--pre_nms_top_n", str(PRE), "--fpn_post_nms_top_n", str(POST)]
RCNN_ARGS = ["--device", "cpu", "--fine_tune", "--backbone_type", "resnet_tiny",
             "--resolution", "32", "--feature_input_dim", "32", "--output_size", "2", "2", "2",
             "--is_flatten", "--is_add_layer"]


def _variables(model, seed):
    """JAX params with noise on every leaf and the running statistics of
    one train-mode batch (not 0 / 1)."""
    rng = np.random.default_rng(seed)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, *SHAPE, 4)))
    params = jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.02, p.shape).astype(np.float32), v["params"])
    other = rng.uniform(0, 1, (2, *SHAPE, 4)).astype(np.float32)
    _, mut = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                         jnp.asarray(other), train=True, mutable=["batch_stats"])
    return params, jax.tree.map(np.asarray, mut["batch_stats"])


def _rpn(rotated):
    model = JNeRFRPN(backbone_type="resnet_tiny", conv_depth=1, rotated=rotated)
    params, stats = _variables(model, 1 + rotated)
    # moderate head outputs: no saturated score ties
    params["rpn_head"]["cls_logits"]["kernel"] *= 0.05
    params["rpn_head"]["bbox_pred"]["kernel"] *= 0.05
    return model, params, stats


def _fcos():
    model = JFCOSOverNeRF(backbone_type="resnet_tiny", num_convs=1, norm_reg_targets=True,
                          centerness_on_reg=True)
    params, stats = _variables(model, 3)
    return model, params, stats


def _rcnn():
    """The JAX RCNN fine-tune state's trees: ``{"backbone", "head"}`` and
    the backbone's own ``batch_stats``."""
    rng = np.random.default_rng(4)
    bvars = jbuild_backbone("resnet_tiny", 32).init(jax.random.PRNGKey(1),
                                                     jnp.zeros((1, *SHAPE, 4)))
    head = JRCNNHead(in_channels=32, add_conv_layers=True, flatten=True)
    hparams = head.init(jax.random.PRNGKey(2), jnp.zeros((1, 2, 2, 2, 32)))["params"]
    noisy = lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32)  # noqa
    params = {"backbone": jax.tree.map(noisy, bvars["params"]),
              "head": jax.tree.map(noisy, hparams)}
    stats = jax.tree.map(lambda s: np.asarray(s) + 0.25, bvars["batch_stats"])
    return head, params, stats


@pytest.fixture(scope="module")
def scene():
    x = np.random.default_rng(7).uniform(0, 1, (1, *SHAPE, 4)).astype(np.float32)
    return x, np.array([[32, 30, 28]], np.int32)


@pytest.fixture(scope="module")
def trees():
    return {"rpn_aabb": _rpn(False), "rpn_obb": _rpn(True), "fcos": _fcos(), "rcnn": _rcnn()}


def _msgpack(tmp_path, name, params, stats):
    path = str(tmp_path / f"{name}.msgpack")
    with open(path, "wb") as f:
        f.write(fser.msgpack_serialize({"params": params, "batch_stats": stats}))
    return path


def _same_tree(got, want):
    flat_g, flat_w = weights.flatten_tree(got), weights.flatten_tree(want)
    assert set(flat_g) == set(flat_w)
    for k, w in flat_w.items():
        g = flat_g[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg="/".join(k))


def _level_close(got, want, rel=1e-5):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.abs(g.detach().numpy() - w).max() <= rel * np.abs(w).max()


@pytest.mark.parametrize("name", ["rpn_aabb", "rpn_obb", "fcos", "rcnn"])
def test_flax_msgpack_reads_back_bit_exact(trees, tmp_path, name):
    _, params, stats = trees[name]
    path = _msgpack(tmp_path, name, params, stats)
    got = flax_msgpack.read_msgpack(path)
    assert set(got) == {"params", "batch_stats"}
    _same_tree(got["params"], params)
    _same_tree(got["batch_stats"], stats)
    with open(path, "rb") as f:
        assert flax_msgpack.packb(got) == f.read()


def test_chunked_leaves_and_bf16(trees, monkeypatch):
    _, params, stats = trees["rpn_aabb"]
    params = jax.tree.map(lambda p: p, params)
    kernel = params["rpn_head"]["bbox_pred"]["kernel"]
    params["rpn_head"]["bbox_pred"]["kernel"] = np.asarray(jnp.asarray(kernel, jnp.bfloat16))
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 1024)
    blob = fser.msgpack_serialize({"params": params, "batch_stats": stats})
    assert b"__msgpack_chunked_array__" in blob
    got = flax_msgpack.unpackb(blob)
    bf16 = got["params"]["rpn_head"]["bbox_pred"]["kernel"]
    assert isinstance(bf16, torch.Tensor) and bf16.dtype == torch.bfloat16
    want = params["rpn_head"]["bbox_pred"]["kernel"]
    assert tuple(bf16.shape) == want.shape
    np.testing.assert_array_equal(bf16.view(torch.int16).numpy(), want.view(np.int16))
    del got["params"]["rpn_head"]["bbox_pred"]["kernel"]
    del params["rpn_head"]["bbox_pred"]["kernel"]
    _same_tree(got["params"], params)
    _same_tree(got["batch_stats"], stats)
    # the writer chunks where flax does and writes its bytes
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 1024)
    got["params"]["rpn_head"]["bbox_pred"]["kernel"] = bf16
    params["rpn_head"]["bbox_pred"]["kernel"] = want
    assert flax_msgpack.packb(got) == blob


def _rpn_trainer(*extra):
    return run_rpn.Trainer(run_rpn.parse_args(["--mode", "eval", *RPN_ARGS, *extra]))


@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
def test_run_rpn_checkpoint_msgpack_matches_jax(trees, tmp_path, scene, rotated):
    model, params, stats = trees["rpn_obb" if rotated else "rpn_aabb"]
    path = _msgpack(tmp_path, "rpn", params, stats)
    trainer = _rpn_trainer("--checkpoint", path, *(["--rotated_bbox"] if rotated else []))
    jstate = JTrainState(step=0, params=params, batch_stats=stats, opt_state=None, tx=None)
    jstep = jax_rpn_step(model, JRPNConfig(rotated=rotated, pre_nms_top_n=PRE,
                                           post_nms_top_n=POST), SHAPE)
    x, _ = scene
    _, obj, dl, _ = trainer.eval_step(SHAPE).forward(torch.from_numpy(x))
    _, jobj, jdl, _ = jstep.forward(jstate, jnp.asarray(x))
    _level_close(obj, jobj)
    _level_close(dl, jdl)


def test_run_fcos_checkpoint_msgpack_and_backbone_only(trees, tmp_path, scene):
    model, params, stats = trees["fcos"]
    path = _msgpack(tmp_path, "fcos", params, stats)
    trainer = run_fcos.Trainer(run_fcos.parse_args(["--mode", "eval", *FCOS_ARGS,
                                                    "--checkpoint", path]))
    jstate = JTrainState(step=0, params=params, batch_stats=stats, opt_state=None, tx=None)
    jstep = jax_fcos_step(model, JFCOSConfig(pre_nms_top_n=PRE, fpn_post_nms_top_n=POST),
                          SHAPE)
    x, _ = scene
    _level_close(trainer.eval_step(SHAPE).forward(torch.from_numpy(x))[:3],
                 jstep.forward(jstate, jnp.asarray(x))[:3])
    # --load_backbone_only from the RPN's file: the RPN's backbone, this
    # model's head as drawn from --seed
    _, rparams, rstats = trees["rpn_aabb"]
    rpath = _msgpack(tmp_path, "rpn", rparams, rstats)
    fresh = run_fcos.Trainer(run_fcos.parse_args(["--mode", "eval", *FCOS_ARGS])).model
    loaded = run_fcos.Trainer(run_fcos.parse_args(["--mode", "eval", *FCOS_ARGS, "--checkpoint",
                                                   rpath, "--load_backbone_only"])).model
    want = weights.from_jax_params(rparams, rstats, loaded.backbone)
    for k, v in loaded.state_dict().items():
        ref = want[k] if k.startswith("backbone.") else fresh.state_dict()[k]
        assert torch.equal(v, ref), k


def test_run_rpn_detect_checkpoint_and_pretrained_msgpack(trees, tmp_path, scene):
    head, params, stats = trees["rcnn"]
    path = _msgpack(tmp_path, "rcnn", params, stats)
    trainer = run_rpn_detect.Trainer(run_rpn_detect.parse_args(
        ["--mode", "eval", *RCNN_ARGS, "--checkpoint", path]))
    model = trainer.model.eval()
    x, _ = scene
    jfeats = jbuild_backbone("resnet_tiny", 32).apply(
        {"params": params["backbone"], "batch_stats": stats}, jnp.asarray(x))
    _level_close(model.backbone(torch.from_numpy(x)), jfeats)
    pooled = np.random.default_rng(5).standard_normal((6, 2, 2, 2, 32)).astype(np.float32)
    jd, js = head.apply({"params": params["head"]}, jnp.asarray(pooled))
    td, ts = model.head(torch.from_numpy(pooled))
    _level_close([td, ts], [jd, js])
    # --pretrained: a stage-1 file's backbone, its batch_stats under "backbone"
    _, rparams, rstats = trees["rpn_aabb"]
    rpath = _msgpack(tmp_path, "rpn", rparams, rstats)
    pre = run_rpn_detect.Trainer(run_rpn_detect.parse_args(
        ["--mode", "train", *RCNN_ARGS, "--pretrained", rpath])).model
    want = weights.from_jax_params(rparams, rstats, pre.backbone)
    for k, v in pre.backbone.state_dict().items():
        assert torch.equal(v, want[f"backbone.{k}"]), k


def _jax_keep_set(model, params, stats, rotated, x, ori):
    jstate = JTrainState(step=0, params=params, batch_stats=stats, opt_state=None, tx=None)
    jstep = jax_rpn_step(model, JRPNConfig(rotated=rotated, pre_nms_top_n=PRE,
                                           post_nms_top_n=POST), SHAPE)
    return jstep(jstate, {"grids": jnp.asarray(x), "ori_sizes": jnp.asarray(ori)})


def _same_proposals(got, want, rotated):
    valid = np.asarray(want["valid"])
    assert valid.sum() > 20
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["level_idx"].numpy(), np.asarray(want["level_idx"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy()[valid], np.asarray(want["boxes"])[valid],
                               rtol=1e-5, atol=(1e-4 if rotated else 1e-5) * SHAPE[0])


def test_an_orbax_directory_is_refused_and_its_export_loads(trees, tmp_path, scene):
    from nerf_rpn_tpu.train.checkpoint import save_checkpoint

    model, params, stats = trees["rpn_aabb"]
    orbax_dir = str(tmp_path / "model_best")
    save_checkpoint(JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                batch_stats=stats, opt_state={}, tx=None), orbax_dir)
    with pytest.raises(ValueError, match="orbax") as err:
        _rpn_trainer("--checkpoint", orbax_dir)
    assert ckpt_lib.ORBAX_EXPORT in str(err.value)
    out = str(tmp_path / "exported.msgpack")
    cmd = shlex.split(ckpt_lib.ORBAX_EXPORT.replace("<dir>", orbax_dir)
                      .replace("<out>.msgpack", out))
    assert cmd[:2] == ["python", "-c"]
    res = subprocess.run([sys.executable, *cmd[1:]], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"),
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    x, ori = scene
    got = _rpn_trainer("--checkpoint", out).eval_step(SHAPE)(torch.from_numpy(x),
                                                            torch.from_numpy(ori))
    _same_proposals(got, _jax_keep_set(model, params, stats, False, x, ori), False)


def _reference_pt(path, params, stats, rotated):
    """A released-layout reference checkpoint of these weights: the head's
    channels in the reference's anchor order, no ``anchor_order`` entry."""
    port = NeRFRPN("resnet_tiny", conv_depth=1, rotated=rotated)
    sd = weights.from_jax_params(params, stats, port.backbone)
    inv = np.argsort(anchor_permutation(DEFAULT_ASPECT_RATIOS[0]))
    head = {}
    for k, v in sd.items():
        if k.startswith("rpn_head."):
            k = k[len("rpn_head."):]
            if k.split(".")[0] in ("cls_logits", "bbox_pred"):
                v = v.reshape(13, -1, *v.shape[1:])[inv].reshape(v.shape)
            head[k] = v
    torch.save({"epoch": 3, "train_args": {"backbone_type": "resnet_tiny"},
                "backbone_state_dict": {k[len("backbone."):]: v for k, v in sd.items()
                                        if k.startswith("backbone.")},
                "rpn_head_state_dict": head}, path)


@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
def test_a_reference_pt_gives_the_jax_proposals(trees, tmp_path, scene, rotated):
    model, params, stats = trees["rpn_obb" if rotated else "rpn_aabb"]
    path = str(tmp_path / "front3d_anchor_resnet.pt")
    _reference_pt(path, params, stats, rotated)
    # the JAX package's route: convert_weights, then its eval step
    conv = jconvert.convert_rpn_checkpoint(jconvert.load_torch_checkpoint(path), "resnet",
                                           conv_depth=1, rotated=rotated, layers=(1, 1, 1, 1))
    x, ori = scene
    want = _jax_keep_set(model, conv["params"], conv["batch_stats"], rotated, x, ori)
    trainer = _rpn_trainer("--checkpoint", path, *(["--rotated_bbox"] if rotated else []))
    got = trainer.eval_step(SHAPE)(torch.from_numpy(x), torch.from_numpy(ori))
    _same_proposals(got, want, rotated)
    # the port's own files carry the marker and load as written
    state = type("State", (), {"model": trainer.model, "optimizer": torch.optim.SGD(
        trainer.model.parameters(), 0.1), "step": 0})()
    state.scheduler = torch.optim.lr_scheduler.LambdaLR(state.optimizer, lambda s: 1.0)
    own = str(tmp_path / "own")
    ckpt_lib.save_checkpoint(state, own)
    assert torch.load(own, weights_only=True)["anchor_order"] == "port"
    again = _rpn_trainer("--checkpoint", own, *(["--rotated_bbox"] if rotated else []))
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, trainer.model.state_dict()[k]), k


@pytest.mark.parametrize("kind", ["rpn_aabb", "rpn_obb", "fcos"])
def test_convert_weights_writes_the_jax_tools_file(tmp_path, kind):
    from nerf_rpn_tpu_torch.models.nerf_rpn import FCOSOverNeRF, init_params

    fcos, rotated = kind == "fcos", kind == "rpn_obb"
    if fcos:
        model = FCOSOverNeRF("swin_t", num_convs=1)
    else:
        model = NeRFRPN("swin_t", conv_depth=1, rotated=rotated)
    init_params(model, torch.Generator().manual_seed(11))
    sd = model.state_dict()
    head = ({f"head.{k[len('fcos_head.'):]}": v for k, v in sd.items()
             if k.startswith("fcos_head.")} if fcos else
            {k[len("rpn_head."):]: v for k, v in sd.items() if k.startswith("rpn_head.")})
    pt = str(tmp_path / "ref.pt")
    torch.save({"epoch": 1, "backbone_state_dict": {
        k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")},
        "fcos_state_dict" if fcos else "rpn_head_state_dict": head}, pt)
    flags = ["--checkpoint", pt, "--backbone_type", "swin_t", "--conv_depth", "1",
             *(["--fcos"] if fcos else []), *(["--rotated"] if rotated else [])]
    jconvert.main([*flags, "--out", str(tmp_path / "jax.msgpack")])
    convert_weights.main([*flags, "--out", str(tmp_path / "port.msgpack")])
    with open(tmp_path / "jax.msgpack", "rb") as f:
        want = f.read()
    with open(tmp_path / "port.msgpack", "rb") as f:
        got = f.read()
    _same_tree(fser.msgpack_restore(got), fser.msgpack_restore(want))
    assert got == want
