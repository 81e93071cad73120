"""Torch port: one ``resnet_tiny`` anchor-RPN train step vs JAX's ``make_rpn_train_step``.

One JAX params tree (init + noise; ``conv_depth`` 1, 64^3, batch 2, f32)
and ``batch_stats`` that are not 0 / 1 are mapped onto the port.  JAX runs
its own jitted ``make_rpn_train_step`` (the model applied with
``train=True`` and ``mutable=["batch_stats"]``, then AdamW with the
one-cycle schedule and the recorded clip); the port runs its train step
with JAX's sampled anchor indices injected (the key that JAX's step hands
to ``rpn_losses`` is the first half of its split).  Compared: the loss
terms, ``grad_norm``, ``param_norm``, every gradient leaf, the updated
parameters and the new running statistics -- and the same with
``--freeze_backbone``, where JAX's ``multi_transform`` zeroes the
backbone's updates but its forward still moves the running statistics.

Tolerances: the loss terms and norms within 1e-4 (relative), each
gradient leaf within 1e-3 of its largest entry, the updated parameters
within one Adam step and, where the gradient is clear, within 1e-3 of a
step, the running statistics within 1e-4 of each leaf's largest:
train-mode BatchNorm divides by batch
variances that f32 sums of another order move by an ulp of E[x^2]
(``tests/test_torch_backbones.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_rpn_tpu.models import rpn as jrpn
from nerf_rpn_tpu.models.nerf_rpn import NeRFRPN as JNeRFRPN
from nerf_rpn_tpu.ops.aabb import pairwise_iou_aabb as jax_iou
from nerf_rpn_tpu.train.state import create_train_state, make_optimizer
from nerf_rpn_tpu.train.steps import level_shapes_for
from nerf_rpn_tpu.train.steps import make_rpn_train_step as jax_train_step
from nerf_rpn_tpu.utils import target_assign as jta
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.models import rpn
from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN
from nerf_rpn_tpu_torch.train.state import TrainState
from nerf_rpn_tpu_torch.train.steps import make_rpn_train_step

SHAPE = (64, 64, 64)
STRIDES = (4, 8, 16, 32)
LR, TOTAL = 1e-3, 10


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _inputs():
    rng = np.random.default_rng(0)
    model = JNeRFRPN(backbone_type="resnet_tiny", conv_depth=1)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 32, 4)))
    params = jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.02, p.shape).astype(np.float32), v["params"])
    params["rpn_head"]["cls_logits"]["kernel"] *= 0.05
    params["rpn_head"]["bbox_pred"]["kernel"] *= 0.05
    stats = jax.tree.map(lambda s: np.asarray(s) + rng.uniform(0.1, 0.3, s.shape).astype(
        np.float32), v["batch_stats"])
    # two unlike scenes: the stage-3 statistics run over 2 x 2^3 values a
    # channel, which two draws of one noise would make nearly equal (an
    # ill-conditioned variance that amplifies f32 rounding)
    grids = rng.uniform(0, 1, (2, *SHAPE, 4)).astype(np.float32)
    grids[1] *= np.linspace(0.2, 3.0, SHAPE[0], dtype=np.float32)[:, None, None, None]
    grids[1, 8:40, 16:48, 20:52, 3] += 2.0
    gt = np.zeros((2, 4, 6), np.float32)
    gt[0, :3] = [[4, 6, 8, 28, 24, 36], [32, 32, 16, 56, 60, 40], [8, 40, 40, 24, 60, 62]]
    gt[1, :2] = [[0, 0, 0, 40, 32, 24], [20, 24, 28, 36, 40, 48]]
    ori = np.array([[64, 60, 64], [56, 64, 52]], np.int32)
    return model, params, stats, dict(grids=grids, gt_boxes=gt, gt_mask=gt[..., 3] > 0,
                                      ori_sizes=ori)


def _jax_indices(b, key):
    cfg = jrpn.RPNConfig()
    shapes = level_shapes_for(SHAPE, STRIDES)
    anchors, _, strides, _ = jrpn.build_level_tables(cfg, SHAPE, shapes)
    pad = jrpn.dynamic_padding_masks(shapes, strides, 13, jnp.asarray(b["ori_sizes"]))
    matches = []
    for i in range(2):
        iou = jnp.where(pad[i][None], jax_iou(jnp.asarray(b["gt_boxes"][i]),
                                              jnp.asarray(anchors)), -1.0)
        m = jta.match_anchors(iou, jnp.asarray(b["gt_mask"][i]), 0.35, 0.2)
        matches.append(jnp.where(pad[i], m, -2))
    # make_rpn_train_step splits its key and samples with the first half
    sample_key = jax.random.split(key)[0]
    indices = jta.sample_balanced_indices(sample_key, jnp.stack(matches), 256, 0.5)
    return [torch.from_numpy(np.array(t)) for t in indices]


def _run(inputs, freeze):
    model, params, stats, b = inputs
    tx, _ = make_optimizer(LR, TOTAL)
    if freeze:
        tx = optax.multi_transform(
            {"train": tx, "frozen": optax.set_to_zero()},
            lambda p: {k: ("frozen" if k == "backbone" else "train") for k in p})
    state = create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 32, 4)), tx)
    state = state.replace(params=params, batch_stats=stats, opt_state=tx.init(params))
    step, _ = jax_train_step(model, jrpn.RPNConfig(), SHAPE, STRIDES)
    key = jax.random.PRNGKey(5)
    new_state, jm = step(state, {k: jnp.asarray(v) for k, v in b.items()}, key)
    # JAX's gradients, for the leaf-by-leaf comparison
    grads = jax.grad(lambda p: _jax_total(model, p, stats, b, key))(params)

    port = NeRFRPN("resnet_tiny", conv_depth=1)
    port.load_state_dict(weights.from_jax_params(params, stats, port.backbone), strict=True)
    pstate = TrainState(port, LR, TOTAL, freeze_backbone=freeze)
    got_grads = {}
    apply = pstate.apply_gradients

    def capture():
        got_grads.update({n: p.grad.clone() for n, p in port.named_parameters()
                          if p.grad is not None})
        return apply()

    pstate.apply_gradients = capture
    pstep = make_rpn_train_step(port, rpn.RPNConfig(), SHAPE, STRIDES)
    pm = pstep(pstate, {k: torch.from_numpy(v) for k, v in b.items()},
               torch.Generator().manual_seed(0), torch.Generator().manual_seed(1),
               indices=_jax_indices(b, key))
    return dict(jm={k: float(v) for k, v in jm.items()}, pm={k: float(v) for k, v in pm.items()},
                new_params=jax.tree.map(np.asarray, new_state.params),
                new_stats=jax.tree.map(np.asarray, new_state.batch_stats),
                grads=jax.tree.map(np.asarray, grads), got_grads=got_grads, port=port,
                params=params, stats=stats)


def _jax_total(model, p, stats, b, key):
    """The total loss of JAX's train step as a function of the params."""
    cfg = jrpn.RPNConfig()
    shapes = level_shapes_for(SHAPE, STRIDES)
    anchors, _, strides, counts = jrpn.build_level_tables(cfg, SHAPE, shapes)
    pad = jrpn.dynamic_padding_masks(shapes, strides, 13, jnp.asarray(b["ori_sizes"]))
    (_, logits, deltas), _ = model.apply({"params": p, "batch_stats": stats},
                                         jnp.asarray(b["grids"]), train=True,
                                         mutable=["batch_stats"])
    obj = jnp.concatenate([l.reshape(2, -1) for l in logits], axis=1)
    losses = jrpn.rpn_losses(cfg, jax.random.split(key)[0], obj, list(deltas),
                             jnp.asarray(anchors), jnp.asarray(b["gt_boxes"]),
                             jnp.asarray(b["gt_mask"]), padding_mask=pad, max_mesh_dim=64,
                             level_counts=counts, anchors_per_loc=13)
    return losses["loss_objectness"] + cfg.reg_loss_weight * losses["loss_rpn_box_reg"]


@pytest.fixture(scope="module", params=[False, True], ids=["trained", "freeze_backbone"])
def steps(request, inputs):
    return _run(inputs, request.param), request.param


def test_loss_terms_and_norms(steps):
    r, _ = steps
    for k in ("loss", "loss_objectness", "loss_rpn_box_reg", "grad_norm", "param_norm"):
        assert r["jm"][k] > 0, k
        np.testing.assert_allclose(r["pm"][k], r["jm"][k], rtol=1e-4, err_msg=k)


def test_every_gradient_leaf(steps):
    r, freeze = steps
    want = weights.from_jax_params(r["grads"], None, r["port"].backbone)
    got = r["got_grads"]
    trained = {k for k in want if not (freeze and k.startswith("backbone."))}
    assert set(got) == trained
    for name in trained:
        w = want[name]
        scale = w.abs().max().item()
        err = (got[name] - w).abs().max().item()
        assert err <= 1e-3 * max(scale, 1e-12), (name, err, scale)


def test_updated_params_and_running_statistics(steps):
    r, freeze = steps
    port = r["port"]
    want = weights.from_jax_params(r["new_params"], r["new_stats"], port.backbone)
    before = weights.from_jax_params(r["params"], r["stats"], port.backbone)
    lr0 = LR / 25.0
    for name, p in port.state_dict().items():
        if name.endswith("num_batches_tracked"):
            assert int(p) == 1, name
            continue
        if "running_" in name:
            w = want[name]
            assert (p - w).abs().max().item() <= 1e-4 * w.abs().max().item(), name
            assert not torch.equal(p, before[name]), name
            continue
        if freeze and name.startswith("backbone."):
            assert torch.equal(p, before[name]) and torch.equal(want[name], before[name])
            continue
        # one Adam step: entries with |g| near eps may step either way
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=2 * lr0 + 1e-6, err_msg=name)
        # entries with a clear gradient (BatchNorm scales and biases
        # included) must take the same step: 1e-3 of a step, plus the f32
        # rounding of the parameter itself
        g = r["got_grads"][name]
        clear = g.abs() > 1e-2 * g.abs().max()
        assert clear.any(), name
        step_port = (p - before[name])[clear]
        step_jax = (want[name] - before[name])[clear]
        assert step_jax.abs().min().item() > 0.5 * lr0, name
        atol = 1e-3 * lr0 + 2.0 ** -22 * before[name].abs().max().item()
        assert torch.allclose(step_port, step_jax, rtol=0, atol=atol), (
            name, (step_port - step_jax).abs().max().item(), atol)
    # the clear-gradient check reached the backbone's BatchNorm scales
    assert freeze or any(".bn" in n and n.endswith(".weight") for n in r["got_grads"])
