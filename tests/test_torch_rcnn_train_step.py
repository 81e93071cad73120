"""Torch port: one RCNN train step (``make_rcnn_train_step``) against JAX's
on the same weights, batch and sample.

Three cases, each one JAX compile: the features mode with AABB RoIs (max
pooling, the conv tower, flatten), the features mode with OBB RoIs (align,
the rotated coder), and ``--fine_tune`` on ``resnet_tiny`` at 32^3 with
batch 2 (the backbone in train mode: batch statistics and a running
update).  JAX's params (init plus noise) and ``batch_stats`` (not 0 / 1)
are carried across by ``weights.rcnn_from_jax_params``; the port's step
takes JAX's sampled RoI indices (the key that JAX's step samples with is
the first half of its split).  Compared: the loss terms, ``grad_norm``,
``param_norm``, every gradient leaf, the parameters after the AdamW update
and the new running statistics.

The features mode runs in f32, the precision the driver trains in: loss
terms and norms within 1e-5 (relative), each gradient leaf within 1e-5 of
the largest entry of its layer (weight and bias: a bias's gradient is a sum
over the sampled rows that cancels, (p - y) for the class scores, so its
own largest entry is no scale for the rounding of its terms).  The
fine-tune case runs in f64 on both sides (``jax.enable_x64(True)``,
the modules built with that dtype, the f32 weights widened): at 32^3 with
batch 2 the last level is 1^3, so its train-mode BatchNorm normalises 2
values a channel, and in f32 their E[x^2] - E[x]^2 leaves the FPN levels
~1e-3 apart between any two f32 implementations (the eval-mode levels
agree to 1e-6).  XLA's CPU convolutions in f64 read ~4e-8 (relative) off
torch's (the stem conv alone), which the BatchNorms amplify ~10x forward
and, through the backward of the few-value statistics, to 3e-5 (median)
and 5.3e-5 (worst) on the stages' leaves, where the head's and the FPN's
read <= 1.7e-6.  So there: loss terms and ``param_norm`` within 1e-6,
``grad_norm`` within 1e-4, each leaf within 1e-4 of its layer's largest
entry, running statistics within 1e-7 of each leaf's largest -- 30x
tighter than the f32 step allows here.  In both: the updated parameters within one Adam step
and, where the gradient is clear, within 1e-3 of a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict

from nerf_rpn_tpu.models import detector as jdet
from nerf_rpn_tpu.models.nerf_rpn import build_backbone as jbuild
from nerf_rpn_tpu.train.state import TrainState as JState
from nerf_rpn_tpu.train.state import make_optimizer
from nerf_rpn_tpu.train.steps import make_rcnn_train_step as jax_train_step
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.models import detector as tdet
from nerf_rpn_tpu_torch.models.nerf_rpn import build_backbone
from nerf_rpn_tpu_torch.train.state import TrainState
from nerf_rpn_tpu_torch.train.steps import make_rcnn_train_step

SCALES = (4, 8, 16, 32)
LR, TOTAL, K = 1e-3, 10, 16           # K: sampled RoIs a scene
REG_W = 5.0                           # the driver's --reg_loss_weight


def _rois(rng, gt, rotated, n=40):
    """Jittered copies of the gt (foreground) and random boxes."""
    out = []
    for g in gt:
        out += [g + rng.uniform(-1, 1, g.shape) * (np.r_[1, 1, 1, 1, 1, 1, 0.1][:g.size])
                for _ in range(4)]
    while len(out) < n:
        c, s = rng.uniform(4, 28, 3), rng.uniform(3, 10, 3)
        out.append(np.r_[c, s, rng.uniform(-1.5, 1.5)] if rotated else np.r_[c - s / 2, c + s / 2])
    return np.asarray(out, np.float32)


def _batch(rotated, fine_tune):
    rng = np.random.default_rng(0)
    b = 2
    if rotated:
        gt = np.array([[[10, 12, 8, 8, 6, 7, 0.3], [22, 20, 18, 6, 9, 5, -0.7]],
                       [[16, 16, 16, 10, 7, 8, 1.2], [6, 24, 10, 5, 5, 6, 0.0]]], np.float32)
    else:
        gt = np.array([[[6, 8, 4, 14, 15, 12], [18, 16, 14, 26, 27, 22]],
                       [[10, 10, 10, 22, 20, 19], [2, 20, 6, 9, 28, 14]]], np.float32)
    gt_mask = np.ones((b, 2), bool)
    rois = np.stack([_rois(rng, g, rotated) for g in gt])
    levels = rng.integers(0, 4, rois.shape[:2]).astype(np.int32)
    valid = np.ones(rois.shape[:2], bool)
    valid[1, -5:] = False
    batch = dict(rois=rois, roi_levels=levels, roi_valid=valid, gt_boxes=gt, gt_mask=gt_mask)
    if fine_tune:
        # two unlike scenes (the deep BatchNorms' statistics run over few
        # values a channel; two draws of one noise would make them all
        # rounding)
        grids = rng.uniform(0, 1, (b, 32, 32, 32, 4)).astype(np.float32)
        grids[1] *= np.linspace(0.2, 3.0, 32, dtype=np.float32)[:, None, None, None]
        grids[1, 4:20, 8:28, 6:30, 3] += 2.0
        batch["grids"] = grids
    else:
        batch["features"] = [rng.standard_normal((b, s, s, s, 16)).astype(np.float32)
                             for s in (8, 4, 2, 1)]
    return batch


CASES = {
    # (rotated, fine_tune, pool mode, conv tower, flatten, channels)
    "features_aabb": (False, False, "max", True, True, 16),
    "features_obb": (True, False, "avg", False, True, 16),
    "finetune_resnet_tiny": (False, True, "max", False, True, 32),
}


def _recording(tx):
    """``tx`` that also keeps the last gradients in its state: JAX's own
    step then gives its gradient leaves, with no second compile."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


def _run(case):
    if CASES[case][1]:
        with jax.enable_x64(True):
            return _run_in(case, jnp.float64, torch.float64)
    return _run_in(case, jnp.float32, torch.float32)


def _run_in(case, jdt, tdt):
    rotated, fine_tune, pool, add, flatten, c = CASES[case]
    rng = np.random.default_rng(1)
    b = _batch(rotated, fine_tune)
    cfg_kw = dict(rotated=rotated, output_size=(2, 2, 2), pool_mode=pool, fg_threshold=0.3,
                  bg_threshold=0.25)
    jcfg, tcfg = jdet.RCNNConfig(**cfg_kw), tdet.RCNNConfig(**cfg_kw)
    jhead = jdet.RCNNHead(in_channels=c, rotated=rotated, add_conv_layers=add, flatten=flatten,
                          dtype=jdt)
    noise = lambda t: jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32), t)
    head_params = noise(jhead.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, 2, c)))["params"])
    backbone, stats = None, None
    if fine_tune:
        backbone = jbuild("resnet_tiny", 32, dtype=jdt)
        bv = backbone.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 32, 4)))
        params = {"backbone": noise(bv["params"]), "head": head_params}
        stats = jax.tree.map(lambda s: np.asarray(s) + rng.uniform(0.1, 0.3, s.shape).astype(
            np.float32), bv["batch_stats"])
    else:
        params = head_params
    wide = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jdt), t)
    params = wide(params)
    stats = wide(stats) if stats is not None else None
    b = {k: [f.astype(jdt) for f in v] if k == "features" else
         (v.astype(jdt) if v.dtype == np.float32 else v) for k, v in b.items()}
    tx = _recording(make_optimizer(LR, TOTAL)[0])
    state = JState(step=jnp.zeros((), jnp.int32), params=params,
                   batch_stats=stats if stats is not None else FrozenDict(),
                   opt_state=tx.init(params), tx=tx)
    step = jax_train_step(jhead, jcfg, SCALES, K, backbone=backbone, reg_loss_weight=REG_W)
    key = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) if not isinstance(v, list) else [jnp.asarray(f) for f in v]
          for k, v in b.items()}
    new_state, jm = step(state, jb, key)
    # the step splits key into (sample key, drop key) and the sample key per scene
    skeys = jax.random.split(jax.random.split(key)[0], 2)
    sampled = jax.vmap(lambda k, r, lv, v, g, gm: jdet.sample_rois(jcfg, k, r, lv, v, g, gm, K))(
        skeys, jb["rois"], jb["roi_levels"], jb["roi_valid"], jb["gt_boxes"], jb["gt_mask"])
    grads = new_state.opt_state[0]

    port = tdet.RCNNDetector(tdet.RCNNHead(c, 2, rotated, add, flatten, (2, 2, 2), tdt),
                             build_backbone("resnet_tiny", 32, tdt) if fine_tune else None)
    port.load_state_dict(weights.rcnn_from_jax_params(params, stats, port.backbone), strict=True)
    port.to(tdt)
    pstate = TrainState(port, LR, TOTAL)
    got_grads = {}
    apply = pstate.apply_gradients

    def capture():
        got_grads.update({n: p.grad.clone() for n, p in port.named_parameters()})
        return apply()

    pstate.apply_gradients = capture
    tb = {k: torch.from_numpy(v) if not isinstance(v, list) else [torch.from_numpy(f) for f in v]
          for k, v in b.items()}
    pm = make_rcnn_train_step(port, tcfg, SCALES, K, reg_loss_weight=REG_W)(
        pstate, tb, None, indices=torch.from_numpy(np.asarray(sampled["indices"])).long())
    n_fg = float(np.asarray(sampled["labels"]).sum())
    return dict(jm={k: float(v) for k, v in jm.items()}, pm={k: float(v) for k, v in pm.items()},
                new_params=_np64(new_state.params),
                new_stats=_np64(new_state.batch_stats) if fine_tune else None,
                grads=_np64(grads), got_grads=got_grads, port=port,
                params=_np64(params), stats=_np64(stats) if fine_tune else None,
                fine_tune=fine_tune, n_fg=n_fg, dtype=np.float64 if fine_tune else np.float32)


def _np64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _state_dict(run, tree, stats=None):
    """The port's ``state_dict`` of a JAX tree in the run's dtype.  The
    converter writes f32, so an f64 tree goes through as the sum of its f32
    part and its f32 remainder (both convert exactly; the sum is within
    2^-48 of each leaf)."""
    def convert(t, s):
        return weights.rcnn_from_jax_params(t, s, run["port"].backbone)

    if run["dtype"] == np.float32:
        return convert(tree, stats)
    hi = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
    lo = lambda t: jax.tree.map(lambda a: np.asarray(a - np.asarray(a, np.float32), np.float32),
                                t)
    none_or = lambda f, t: None if t is None else f(t)
    a, b = convert(hi(tree), none_or(hi, stats)), convert(lo(tree), none_or(lo, stats))
    return {k: v.double() + b[k].double() if v.is_floating_point() else v
            for k, v in a.items()}


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    return _run(request.param)


def test_loss_terms_and_norms(run):
    rtol = 1e-6 if run["fine_tune"] else 1e-5
    assert 0 < run["n_fg"] < 2 * K
    assert run["pm"]["fg_rois"] == run["n_fg"]
    assert run["pm"]["fg_rois"] + run["pm"]["bg_rois"] == 2 * K
    for k in ("loss", "loss_objectness", "loss_rpn_box_reg", "grad_norm", "param_norm"):
        assert run["jm"][k] > 0, k
        tol = 1e-4 if run["fine_tune"] and k == "grad_norm" else rtol
        np.testing.assert_allclose(run["pm"][k], run["jm"][k], rtol=tol, err_msg=k)


def test_every_gradient_leaf(run):
    want = _state_dict(run, run["grads"])
    got = run["got_grads"]
    assert set(got) == set(want)
    tol = 1e-4 if run["fine_tune"] else 1e-5
    layer_scale = {}
    for name, w in want.items():
        layer = name.rsplit(".", 1)[0]
        layer_scale[layer] = max(layer_scale.get(layer, 0.0), w.abs().max().item())
    for name, w in want.items():
        scale = layer_scale[name.rsplit(".", 1)[0]]
        err = (got[name] - w).abs().max().item()
        assert err <= tol * max(scale, 1e-12), (name, err, scale)
    assert any(n.startswith("backbone.") for n in got) == run["fine_tune"]


def test_updated_params_and_running_statistics(run):
    port = run["port"]
    want = _state_dict(run, run["new_params"], run["new_stats"])
    before = _state_dict(run, run["params"], run["stats"])
    lr0 = LR / 25.0
    stats_tol = 1e-7
    for name, p in port.state_dict().items():
        if name.endswith("num_batches_tracked"):
            assert int(p) == 1, name
            continue
        if "running_" in name:
            w = want[name]
            assert (p - w).abs().max().item() <= stats_tol * w.abs().max().item(), name
            assert not torch.equal(p, before[name]), name
            continue
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=2 * lr0 + 1e-6, err_msg=name)
        g = run["got_grads"][name]
        clear = g.abs() > 1e-2 * g.abs().max()
        assert clear.any(), name
        step_port = (p - before[name])[clear]
        step_jax = (want[name] - before[name])[clear]
        atol = 1e-3 * lr0 + 2.0 ** -22 * before[name].abs().max().item()
        assert torch.allclose(step_port, step_jax, rtol=0, atol=atol), (
            name, (step_port - step_jax).abs().max().item(), atol)
