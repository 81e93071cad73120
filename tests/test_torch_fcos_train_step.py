"""Torch port: one whole OBB FCOS train step vs JAX (``train_fcos.sh``'s losses).

One JAX params tree (swin_t, ``num_convs`` 1, 32^3, batch 2, f32, OBBs,
``--norm_reg_targets --centerness_on_reg``, ``iou_loss_type="iou"``,
center sampling radius 1.5) is mapped onto the port with
``from_jax_params``.  JAX takes ``value_and_grad`` of ``fcos_losses`` on
``FCOSOverNeRF.apply(train=True)`` -- the head's distances are not
multiplied by the stride in train mode -- with the Swin stochastic depth
at 0, and one ``make_optimizer`` update; the port runs its FCOS train step
with every drop-path rate at 0.  The loss terms, ``grad_norm``, every
gradient leaf and the updated parameters are compared, and the port's
``dropped_positives`` metric is 0 at this radius.  One JAX train-step jit
in this file (~1.5 min on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_rpn_tpu.models import fcos as jf
from nerf_rpn_tpu.models import swin as jswin
from nerf_rpn_tpu.models.nerf_rpn import FCOSOverNeRF as JFCOSOverNeRF
from nerf_rpn_tpu.train.state import make_optimizer
from nerf_rpn_tpu.train.steps import level_shapes_for
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.models.fcos import FCOSConfig
from nerf_rpn_tpu_torch.models.nerf_rpn import FCOSOverNeRF
from nerf_rpn_tpu_torch.models.swin import SwinBlock
from nerf_rpn_tpu_torch.train.state import TrainState
from nerf_rpn_tpu_torch.train.steps import make_fcos_train_step

SHAPE = (32, 32, 32)
STRIDES = (4, 8, 16, 32)
LR, TOTAL = 1e-3, 10
CFG = dict(rotated=True, fpn_strides=STRIDES, iou_loss_type="iou", norm_reg_targets=True,
           center_sampling_radius=1.5)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    model = JFCOSOverNeRF(backbone_type="swin_t", num_convs=1, rotated=True,
                          norm_reg_targets=True, centerness_on_reg=True)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, *SHAPE, 4)))["params"]
    params = jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.02, p.shape).astype(np.float32), params)
    grids = rng.uniform(0, 1, (2, *SHAPE, 4)).astype(np.float32)
    gt = np.zeros((2, 3, 7), np.float32)  # [x, y, z, w, l, h, theta]
    gt[0, :2] = [[10, 11, 12, 12, 7, 10, 0.4], [22, 21, 18, 9, 13, 11, -1.0]]
    # a long box: its locations with a far face 16-32 away are level 1's
    gt[1, :2] = [[15, 16, 14, 14, 10, 9, 0.9], [16, 15, 17, 36, 12, 14, 0.2]]
    mask = gt[..., 3] > 0
    ori = np.array([[32, 30, 32], [28, 32, 30]], np.int32)
    return model, params, dict(grids=grids, gt_boxes=gt, gt_mask=mask, ori_sizes=ori)


@pytest.fixture(scope="module")
def jax_step(inputs):
    model, params, b = inputs
    cfg = jf.FCOSConfig(**CFG)
    loc, _, _, stride_of, soi = jf.fcos_locations(level_shapes_for(SHAPE, STRIDES), STRIDES)
    pad = jf.fcos_padding_mask(loc, jnp.asarray(b["ori_sizes"]))
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        _, cls, reg, ctr = model.apply({"params": p}, jnp.asarray(b["grids"]), train=True,
                                       rngs={"dropout": key})
        losses = jf.fcos_losses(
            cfg, jf.flatten_fcos_outputs(cls, 1), jf.flatten_fcos_outputs(reg, 8),
            jf.flatten_fcos_outputs(ctr, 1), jnp.asarray(loc), jnp.asarray(stride_of),
            jnp.asarray(soi), jnp.asarray(b["gt_boxes"]), jnp.asarray(b["gt_mask"]),
            padding_mask=pad)
        return losses["loss_cls"] + losses["loss_reg"] + losses["loss_centerness"], losses

    # the Swin stochastic depth off while JAX traces the step
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jswin.SWIN_VARIANTS, "swin_t",
                   dict(jswin.SWIN_VARIANTS["swin_t"], stochastic_depth_prob=0.0))
        (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx, _ = make_optimizer(LR, TOTAL)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)
    return dict(total=float(total), losses={k: float(v) for k, v in losses.items()},
                grads=jax.tree.map(np.asarray, grads),
                grad_norm=float(optax.global_norm(grads)),
                new_params=jax.tree.map(np.asarray, new_params),
                param_norm=float(optax.global_norm(new_params)))


@pytest.fixture(scope="module")
def port_step(inputs):
    _, params, b = inputs
    model = FCOSOverNeRF("swin_t", num_convs=1, rotated=True)
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
    step = make_fcos_train_step(model, FCOSConfig(**CFG), SHAPE)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    metrics = step(state, batch, torch.Generator().manual_seed(1))
    return model, metrics, grads


def test_loss_and_metrics(jax_step, port_step):
    _, metrics, _ = port_step
    assert set(metrics) == {"loss", "loss_cls", "loss_reg", "loss_centerness",
                            "dropped_positives", "grad_norm", "param_norm"}
    assert float(metrics["dropped_positives"]) == 0.0
    # f32 through 12 Swin blocks, the FPN and the head in another order
    np.testing.assert_allclose(float(metrics["loss"]), jax_step["total"], rtol=1e-5)
    for k, v in jax_step["losses"].items():
        assert v > 0, k
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(metrics["grad_norm"]), jax_step["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["param_norm"]), jax_step["param_norm"], rtol=1e-4)


def test_every_gradient_leaf(jax_step, port_step):
    _, _, grads = port_step
    want = weights.from_jax_params(jax_step["grads"])
    assert set(want) == set(grads)
    assert grads["fcos_head.bbox_pred.weight"].shape[0] == 8
    for name, w in want.items():
        scale = w.abs().max().item()
        if scale == 0:  # no positive reaches this leaf (a level's Scale)
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
        # one Adam step is at most lr0 * (1 + wd |p|); where |g| ~ eps its
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
    model = FCOSOverNeRF("swin_t", num_convs=1)
    with pytest.raises(ValueError, match="AABB"):
        make_fcos_train_step(model, FCOSConfig(rotated=True), SHAPE)
