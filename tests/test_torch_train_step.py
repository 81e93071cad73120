"""Torch port: one whole anchor-RPN train step vs JAX, and stochastic depth.

One JAX params tree (swin_t, ``conv_depth`` 1, 32^3, batch 2, f32) is
mapped onto the port with ``from_jax_params``.  JAX takes
``value_and_grad`` of ``rpn_losses`` on ``model.apply(train=False)`` (in
the Swin the only train-mode difference is stochastic depth, whose random
bits cannot match) and one ``make_optimizer`` update; the port runs its
train step with every drop-path rate set to 0 and JAX's sampled anchor
indices injected.  Loss, metrics, every gradient leaf and the updated
parameters are compared.  The JAX attention takes its plain jnp path on
the CPU; the port's goes through the autograd function (K1 / K2 twins).
``swin_t``'s third stage is cut from 6 blocks to 2 in both packages
(``two_blocks_a_stage``): the step is the same function of any depth, and
the JAX jit's compile time grows with it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.models import rpn as jrpn
from nerf_rpn_tpu.models import swin as jswin
from nerf_rpn_tpu.models.nerf_rpn import NeRFRPN as JNeRFRPN
from nerf_rpn_tpu.models.swin import make_swin_fpn as jax_swin
from nerf_rpn_tpu.ops.aabb import pairwise_iou_aabb as jax_iou
from nerf_rpn_tpu.train.state import make_optimizer
from nerf_rpn_tpu.train.steps import level_shapes_for
from nerf_rpn_tpu.utils import target_assign as jta
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.models import rpn
from nerf_rpn_tpu_torch.models import swin as port_swin
from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN
from nerf_rpn_tpu_torch.models.swin import SwinBlock, SwinFPN, stochastic_depth
from nerf_rpn_tpu_torch.train.state import TrainState
from nerf_rpn_tpu_torch.train.steps import make_rpn_train_step

SHAPE = (32, 32, 32)
STRIDES = (4, 8, 16, 32)
LR, TOTAL = 1e-3, 10


@pytest.fixture(scope="module", autouse=True)
def two_blocks_a_stage():
    """``swin_t`` with depths (2, 2, 2, 2) in both packages' tables for the
    module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        for table in (jswin.SWIN_VARIANTS, port_swin.SWIN_VARIANTS):
            mp.setitem(table, "swin_t", dict(table["swin_t"], depths=(2, 2, 2, 2)))
        yield


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    model = JNeRFRPN(backbone_type="swin_t", conv_depth=1)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, *SHAPE, 4)))["params"]
    params = jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.02, p.shape).astype(np.float32), params)
    # moderate head outputs: boxes near their anchors keep the projected
    # corners in front of the cameras, where the 2D loss is well conditioned
    params["rpn_head"]["cls_logits"]["kernel"] *= 0.05
    params["rpn_head"]["bbox_pred"]["kernel"] *= 0.05
    grids = rng.uniform(0, 1, (2, *SHAPE, 4)).astype(np.float32)
    gt = np.zeros((2, 4, 6), np.float32)
    gt[0, :3] = [[2, 3, 4, 14, 12, 18], [16, 16, 8, 28, 30, 20], [4, 20, 20, 12, 30, 31]]
    gt[1, :2] = [[0, 0, 0, 20, 16, 12], [10, 12, 14, 18, 20, 24]]
    mask = gt[..., 3] > 0
    ori = np.array([[32, 30, 32], [28, 32, 26]], np.int32)
    return model, params, dict(grids=grids, gt_boxes=gt, gt_mask=mask, ori_sizes=ori)


@pytest.fixture(scope="module")
def jax_step(inputs):
    model, params, b = inputs
    cfg = jrpn.RPNConfig(reg_loss_weight=5.0, reg_loss_weight_2d=0.5)
    shapes = level_shapes_for(SHAPE, STRIDES)
    anchors, _, strides, counts = jrpn.build_level_tables(cfg, SHAPE, shapes)
    pad = jrpn.dynamic_padding_masks(shapes, strides, 13, jnp.asarray(b["ori_sizes"]))
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        _, logits, deltas = model.apply({"params": p}, jnp.asarray(b["grids"]), train=False)
        obj = jnp.concatenate([l.reshape(2, -1) for l in logits], axis=1)
        losses = jrpn.rpn_losses(
            cfg, key, obj, list(deltas), jnp.asarray(anchors), jnp.asarray(b["gt_boxes"]),
            jnp.asarray(b["gt_mask"]), padding_mask=pad, max_mesh_dim=32,
            level_counts=counts, anchors_per_loc=13)
        total = (losses["loss_objectness"] + 5.0 * losses["loss_rpn_box_reg"]
                 + 0.5 * losses["loss_rpn_box_reg_2d"])
        return total, losses

    (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx, _ = make_optimizer(LR, TOTAL)
    updates, _ = tx.update(grads, tx.init(params), params)
    import optax

    new_params = optax.apply_updates(params, updates)
    # the anchors rpn_losses sampled: same key, same matches
    matches = []
    for i in range(2):
        iou = jnp.where(pad[i][None], jax_iou(jnp.asarray(b["gt_boxes"][i]), jnp.asarray(anchors)), -1.0)
        m = jta.match_anchors(iou, jnp.asarray(b["gt_mask"][i]), 0.35, 0.2)
        matches.append(jnp.where(pad[i], m, -2))
    indices = jta.sample_balanced_indices(key, jnp.stack(matches), 256, 0.5)
    return dict(total=float(total), losses={k: float(v) for k, v in losses.items()},
                grads=jax.tree.map(np.asarray, grads),
                grad_norm=float(optax.global_norm(grads)),
                new_params=jax.tree.map(np.asarray, new_params),
                param_norm=float(optax.global_norm(new_params)),
                indices=[torch.from_numpy(np.array(t)) for t in indices])


@pytest.fixture(scope="module")
def port_step(inputs, jax_step):
    _, params, b = inputs
    model = NeRFRPN("swin_t", conv_depth=1)
    model.load_state_dict(weights.from_jax_params(params), strict=True)
    for m in model.modules():
        if isinstance(m, SwinBlock):
            m.drop_path = 0.0
    state = TrainState(model, LR, TOTAL)
    grads = {}
    apply = state.apply_gradients

    def capture():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        return apply()

    state.apply_gradients = capture
    step = make_rpn_train_step(
        model, rpn.RPNConfig(reg_loss_weight=5.0, reg_loss_weight_2d=0.5), SHAPE, STRIDES)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    metrics = step(state, batch, torch.Generator().manual_seed(0),
                   torch.Generator().manual_seed(1), indices=jax_step["indices"])
    return model, metrics, grads


def test_loss_and_metrics(jax_step, port_step):
    _, metrics, _ = port_step
    assert set(metrics) == {"loss", "loss_objectness", "loss_rpn_box_reg",
                            "loss_rpn_box_reg_2d", "grad_norm", "param_norm"}
    # f32 through 8 Swin blocks, the FPN and the head in another order
    np.testing.assert_allclose(float(metrics["loss"]), jax_step["total"], rtol=1e-5)
    for k, v in jax_step["losses"].items():
        assert v > 0, k
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(metrics["grad_norm"]), jax_step["grad_norm"], rtol=1e-5)
    # after the update: entries with |g| near Adam's eps take steps of
    # either sign (see the next-but-one test), so 1e-4 and not 1e-5
    np.testing.assert_allclose(float(metrics["param_norm"]), jax_step["param_norm"], rtol=1e-4)


def test_every_gradient_leaf(jax_step, port_step):
    _, _, grads = port_step
    want = weights.from_jax_params(jax_step["grads"])
    assert set(want) == set(grads)
    for name, w in want.items():
        scale = w.abs().max().item()
        if scale == 0:  # no sampled anchor reaches this leaf
            assert torch.all(grads[name] == 0), name
            continue
        # 1e-3 of each leaf's largest entry: f32 sums of different order
        # through the backward of every layer above the leaf
        err = (grads[name] - w).abs().max().item()
        assert err <= 1e-3 * scale, (name, err, scale)


def test_parameters_after_one_update(inputs, jax_step, port_step):
    model, _, grads = port_step
    want = weights.from_jax_params(jax_step["new_params"])
    before = weights.from_jax_params(inputs[1])
    lr0 = LR / 25.0
    for name, p in model.state_dict().items():
        if name not in want:
            continue
        # the first Adam step moves each entry by lr0 * (g / (|g| + eps) +
        # wd * p): where |g| ~ eps the sign and size of the step follow the
        # gradient's last digits, so the bound is one step, 2 * lr0;
        # entries with a clear gradient must take the same step
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=2 * lr0 + 1e-6, err_msg=name)
        g = grads[name]
        clear = g.abs() > 1e-2 * g.abs().max()
        step_port = (p - before[name])[clear]
        step_jax = (want[name] - before[name])[clear]
        # 1e-3 of a step, plus the f32 rounding of the parameter itself
        atol = 1e-3 * lr0 + 2.0 ** -22 * before[name].abs().max().item()
        assert torch.allclose(step_port, step_jax, rtol=0, atol=atol), name


def test_stochastic_depth_masks_and_scaling():
    y = torch.ones((4000, 2, 2, 2, 3))
    out = stochastic_depth(y, 0.3, torch.Generator().manual_seed(0))
    per_sample = out.reshape(4000, -1)
    # one keep/drop draw per sample, kept samples scaled by 1 / keep
    assert torch.all(per_sample == per_sample[:, :1])
    vals = per_sample[:, 0]
    assert vals.unique().tolist() == [0.0, pytest.approx(1 / 0.7)]
    assert abs((vals > 0).float().mean().item() - 0.7) < 0.03
    yb = torch.ones((64, 3), dtype=torch.bfloat16)
    ob = stochastic_depth(yb, 0.3, torch.Generator().manual_seed(1))
    assert ob.dtype == torch.bfloat16
    assert torch.equal(ob[ob > 0], (yb[ob > 0] / 0.7))
    again = stochastic_depth(y, 0.3, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


def test_stochastic_depth_rates_follow_the_jax_schedule():
    for variant in ("swin_t", "swin_s"):
        bb = jax_swin(variant)
        total = sum(bb.depths)
        want = [bb.stochastic_depth_prob * i / max(total - 1, 1) for i in range(total)]
        port = NeRFRPN(variant, conv_depth=1).backbone
        got = [m.drop_path for m in port.modules() if isinstance(m, SwinBlock)]
        assert got == pytest.approx(want, abs=0)
        assert got[0] == 0.0 and got[-1] == pytest.approx(0.1)


def test_stochastic_depth_is_the_identity_in_eval_and_random_in_train():
    torch.manual_seed(0)
    bb = SwinFPN(embed_dim=24, depths=(2, 2), num_heads=(2, 4), stochastic_depth_prob=0.5)
    x = torch.rand((3, 16, 16, 16, 4))
    bb.eval()
    ref = bb(x)
    assert all(torch.equal(a, b) for a, b in zip(ref, bb(x, torch.Generator().manual_seed(3))))
    bb.train()
    with pytest.raises(ValueError):
        bb(x)
    one = bb(x, torch.Generator().manual_seed(3))
    two = bb(x, torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert not all(torch.equal(a, b) for a, b in zip(one, ref))
