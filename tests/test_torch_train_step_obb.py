"""Torch port: one whole OBB anchor-RPN train step vs JAX (``--rotated_bbox``).

As ``test_torch_train_step.py``, for a rotated model: one JAX params tree
(swin_t, ``conv_depth`` 1, 32^3, batch 2, f32; the head predicts 8
midpoint-offset deltas an anchor) is mapped onto the port with
``from_jax_params``.  JAX takes ``value_and_grad`` of ``rpn_losses`` with
``RPNConfig(rotated=True)`` on ``model.apply(train=False)`` and one
``make_optimizer`` update; the port runs its train step with every
drop-path rate at 0 and JAX's sampled anchor indices injected.  The gt
boxes are OBBs, matched to the anchors by their enclosing AABBs; the
regression is smooth-L1 on the midpoint-offset targets, and
``reg_loss_weight_2d`` > 0 puts ``obb2points_3d`` in the 2D projection
loss.  Loss, metrics, every gradient leaf and the updated parameters are
compared.
``swin_t``'s third stage is cut from 6 blocks to 2 in both packages
(``two_blocks_a_stage``): the step is the same function of any depth, and
the JAX jit's compile time grows with it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_rpn_tpu.models import rpn as jrpn
from nerf_rpn_tpu.models import swin as jswin
from nerf_rpn_tpu.models.nerf_rpn import NeRFRPN as JNeRFRPN
from nerf_rpn_tpu.ops.aabb import pairwise_iou_aabb as jax_iou
from nerf_rpn_tpu.ops.obb import obb2hbb_3d as jax_obb2hbb_3d
from nerf_rpn_tpu.train.state import make_optimizer
from nerf_rpn_tpu.train.steps import level_shapes_for
from nerf_rpn_tpu.utils import target_assign as jta
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.models import rpn
from nerf_rpn_tpu_torch.models import swin as port_swin
from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN
from nerf_rpn_tpu_torch.models.swin import SwinBlock
from nerf_rpn_tpu_torch.train.state import TrainState
from nerf_rpn_tpu_torch.train.steps import make_rpn_train_step

SHAPE = (32, 32, 32)
STRIDES = (4, 8, 16, 32)
LR, TOTAL = 1e-3, 10
REG_W, REG_W_2D = 5.0, 0.5


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
    model = JNeRFRPN(backbone_type="swin_t", conv_depth=1, rotated=True)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, *SHAPE, 4)))["params"]
    params = jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.02, p.shape).astype(np.float32), params)
    # moderate head outputs: boxes near their anchors keep the projected
    # points in front of the cameras, where the 2D loss is well conditioned
    params["rpn_head"]["cls_logits"]["kernel"] *= 0.05
    params["rpn_head"]["bbox_pred"]["kernel"] *= 0.05
    grids = rng.uniform(0, 1, (2, *SHAPE, 4)).astype(np.float32)
    gt = np.zeros((2, 4, 7), np.float32)  # [x, y, z, w, l, h, theta]
    gt[0, :3] = [[8, 8, 11, 10, 7, 12, 0.4], [22, 23, 14, 9, 12, 10, -1.1],
                 [8, 25, 25, 6, 9, 9, 1.3]]
    gt[1, :2] = [[10, 8, 6, 18, 14, 10, -0.2], [14, 16, 19, 7, 9, 8, 0.8]]
    mask = gt[..., 3] > 0
    ori = np.array([[32, 30, 32], [28, 32, 26]], np.int32)
    return model, params, dict(grids=grids, gt_boxes=gt, gt_mask=mask, ori_sizes=ori)


@pytest.fixture(scope="module")
def jax_step(inputs):
    model, params, b = inputs
    cfg = jrpn.RPNConfig(rotated=True, reg_loss_weight=REG_W, reg_loss_weight_2d=REG_W_2D)
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
        total = (losses["loss_objectness"] + REG_W * losses["loss_rpn_box_reg"]
                 + REG_W_2D * losses["loss_rpn_box_reg_2d"])
        return total, losses

    (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx, _ = make_optimizer(LR, TOTAL)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)
    # the anchors rpn_losses sampled: same key, same matches (OBBs matched
    # by their enclosing AABBs)
    matches = []
    for i in range(2):
        hbb = jax_obb2hbb_3d(jnp.asarray(b["gt_boxes"][i]))
        iou = jnp.where(pad[i][None], jax_iou(hbb, jnp.asarray(anchors)), -1.0)
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
    model = NeRFRPN("swin_t", conv_depth=1, rotated=True)
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
    cfg = rpn.RPNConfig(rotated=True, reg_loss_weight=REG_W, reg_loss_weight_2d=REG_W_2D)
    step = make_rpn_train_step(model, cfg, SHAPE, STRIDES)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    metrics = step(state, batch, torch.Generator().manual_seed(0),
                   torch.Generator().manual_seed(1), indices=jax_step["indices"])
    return model, metrics, grads


def test_sample_has_positives_of_both_scenes(jax_step):
    pos_take = jax_step["indices"][1]
    assert pos_take.shape[0] == 2 and bool(pos_take[0].any()) and bool(pos_take[1].any())


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
    # either sign, so 1e-4 and not 1e-5 (as in the AABB step's test)
    np.testing.assert_allclose(float(metrics["param_norm"]), jax_step["param_norm"], rtol=1e-4)


def test_every_gradient_leaf(jax_step, port_step):
    _, _, grads = port_step
    want = weights.from_jax_params(jax_step["grads"])
    assert set(want) == set(grads)
    assert grads["rpn_head.bbox_pred.weight"].shape[0] == 13 * 8
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
        # one Adam step is at most lr0 * (1 + wd |p|): where |g| ~ eps its
        # sign follows the gradient's last digits, so the bound is 2 * lr0;
        # entries with a clear gradient must take the same step
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=2 * lr0 + 1e-6, err_msg=name)
        g = grads[name]
        clear = g.abs() > 1e-2 * g.abs().max()
        step_port = (p - before[name])[clear]
        step_jax = (want[name] - before[name])[clear]
        atol = 1e-3 * lr0 + 2.0 ** -22 * before[name].abs().max().item()
        assert torch.allclose(step_port, step_jax, rtol=0, atol=atol), name


def test_model_and_config_must_agree():
    model = NeRFRPN("swin_t", conv_depth=1)
    with pytest.raises(ValueError, match="AABB"):
        make_rpn_train_step(model, rpn.RPNConfig(rotated=True), SHAPE, STRIDES)
