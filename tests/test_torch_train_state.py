"""Torch port: the optimizer, schedule and clip vs optax.

- the learning rate at every step against ``optax.cosine_onecycle_schedule``
  (``transition_steps = max(T, 4)``) for T in {1, 3, 4, 10, 100};
- three updates of a random parameter tree against the JAX CLI's
  ``optax.chain(clip_by_global_norm_recorded, adamw)``, with the clip
  triggered and not, and the recorded pre-clip norm;
- ``--freeze_backbone``: the backbone gets no update and no decay, and the
  clip norm covers the head only (JAX: ``optax.multi_transform`` with
  ``set_to_zero`` on the backbone).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from nerf_rpn_tpu.train.state import make_optimizer, recorded_grad_norm
from nerf_rpn_tpu_torch.train.state import TrainState, onecycle_factor


class Tiny(nn.Module):
    """Two parameter groups named like the model's top-level modules."""

    def __init__(self, tree):
        super().__init__()
        self.backbone = nn.ParameterDict(
            {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in tree["backbone"].items()})
        self.rpn_head = nn.ParameterDict(
            {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in tree["rpn_head"].items()})


def _tree(rng):
    return {"backbone": {"a": rng.normal(0, 1, (7, 5)).astype(np.float32),
                         "b": rng.normal(0, 1, (11,)).astype(np.float32)},
            "rpn_head": {"c": rng.normal(0, 1, (3, 4, 2)).astype(np.float32)}}


@pytest.mark.parametrize("total", [1, 3, 4, 10, 100])
def test_schedule_equals_optax_at_every_step(total):
    lr = 3e-4
    want = optax.cosine_onecycle_schedule(max(total, 4), lr, 0.3, 25.0, 1e4)
    state = TrainState(Tiny(_tree(np.random.default_rng(0))), lr, total)
    for step in range(total + 3):
        got = state.optimizer.param_groups[0]["lr"]
        # optax evaluates the cosine in f32: 1e-6 of the peak (near the
        # end of the cycle cos + 1 cancels, so not 1e-6 of the value)
        np.testing.assert_allclose(got, float(want(step)), rtol=0, atol=1e-6 * lr)
        assert got == pytest.approx(lr * onecycle_factor(step, total))
        state.optimizer.step()  # no gradients: the parameters stay
        state.scheduler.step()


def _jax_updates(tree, grads, lr, total, clip, freeze):
    tx, _ = make_optimizer(lr, total, 0.01, clip)
    if freeze:
        label = lambda p: {k: ("frozen" if k == "backbone" else "train") for k in p}
        tx = optax.multi_transform({"train": tx, "frozen": optax.set_to_zero()}, label)
    params = jax.tree.map(jnp.asarray, tree)
    opt = tx.init(params)
    out = []
    for g in grads:
        updates, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, params)
        params = optax.apply_updates(params, updates)
        out.append((jax.tree.map(np.asarray, params), float(recorded_grad_norm(opt))))
    return out


@pytest.mark.parametrize("clip,freeze", [(0.1, False), (1e6, False), (0.1, True)])
def test_updates_equal_optax(clip, freeze):
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    grads = [jax.tree.map(lambda p: rng.normal(0, 1, p.shape).astype(np.float32), tree)
             for _ in range(3)]
    lr, total = 1e-2, 10
    want = _jax_updates(tree, grads, lr, total, clip, freeze)
    model = Tiny(tree)
    state = TrainState(model, lr, total, 0.01, clip, freeze_backbone=freeze)
    names = {"backbone": model.backbone, "rpn_head": model.rpn_head}
    for g, (want_params, want_norm) in zip(grads, want):
        for part, mod in names.items():
            for k, p in mod.items():
                if p.requires_grad:
                    p.grad = torch.from_numpy(g[part][k].copy())
        norm = float(state.apply_gradients())
        # the clip norm: head only when the backbone is frozen
        np.testing.assert_allclose(norm, want_norm, rtol=1e-6)
        for part, mod in names.items():
            for k, p in mod.items():
                # f32 AdamW in another order of operations
                np.testing.assert_allclose(p.detach().numpy(), want_params[part][k],
                                           rtol=2e-6, atol=1e-7, err_msg=f"{part}/{k}")
    if freeze:
        for k, p in model.backbone.items():
            np.testing.assert_array_equal(p.detach().numpy(), tree["backbone"][k])
        assert all(p.requires_grad for p in model.rpn_head.parameters())
        assert len(state.params) == 1
