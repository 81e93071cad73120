"""Torch port: ``init_params`` draws from the flax initialisers' laws.

- LeCun-normal kernels: flax's ``lecun_normal`` is a normal cut at +-2
  sigma and rescaled by 1/0.87962566, so every sample lies within
  2 / (0.8796 sqrt(fan_in)) and a large tensor's sample std matches
  ``jax.nn.initializers.lecun_normal()``'s within 2%;
- relative-position tables: ``truncated_normal(0.02)``, cut at +-0.04
  without a rescale;
- a seeded generator gives the same weights twice.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as fnn
from torch import nn

from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN, init_params


class Wide(nn.Module):
    """Parameter names that take the kernel and the bias-table branches."""

    def __init__(self):
        super().__init__()
        self.backbone = nn.ModuleDict({"fc": nn.Linear(512, 2048),
                                       "conv": nn.Conv3d(64, 256, 3)})
        self.relative_position_bias_table = nn.Parameter(torch.zeros(343 * 24, 48))


def test_laws_match_flax():
    m = Wide()
    init_params(m, torch.Generator().manual_seed(0))
    key = jax.random.PRNGKey(0)
    cases = [
        (m.backbone["fc"].weight, jax.nn.initializers.lecun_normal()(key, (512, 2048)), 512),
        (m.backbone["conv"].weight,
         jax.nn.initializers.lecun_normal()(key, (3, 3, 3, 64, 256)), 27 * 64),
    ]
    for w, ref, fan_in in cases:
        bound = 2.0 / (0.87962566103423978 * math.sqrt(fan_in))
        assert w.abs().max().item() <= bound * (1 + 1e-6)
        assert w.abs().max().item() > 0.95 * bound
        ref = np.asarray(ref)
        assert np.abs(ref).max() <= bound * (1 + 1e-6)
        np.testing.assert_allclose(w.std().item(), ref.std(), rtol=0.02)
        np.testing.assert_allclose(w.std().item(), 1 / math.sqrt(fan_in), rtol=0.02)
        assert abs(w.mean().item()) < 0.02 / math.sqrt(fan_in) * 10
    assert torch.all(m.backbone["fc"].bias == 0)
    t = m.relative_position_bias_table
    ref = np.asarray(fnn.initializers.truncated_normal(0.02)(key, tuple(t.shape), jnp.float32))
    assert t.abs().max().item() <= 0.04 and np.abs(ref).max() <= 0.04
    np.testing.assert_allclose(t.std().item(), ref.std(), rtol=0.02)


def test_seeded_generator_repeats_and_head_stays_normal():
    a, b, c = (NeRFRPN("swin_t", conv_depth=1) for _ in range(3))
    init_params(a, torch.Generator().manual_seed(5))
    init_params(b, torch.Generator().manual_seed(5))
    init_params(c, torch.Generator().manual_seed(6))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["backbone.stages.0.0.attn.qkv.weight"],
                           sc["backbone.stages.0.0.attn.qkv.weight"])
    # the RPN-head convs are flax normal(0.01): not truncated
    w = a.rpn_head.conv[0].weight
    assert w.abs().max().item() > 0.04
    np.testing.assert_allclose(w.std().item(), 0.01, rtol=0.02)
    for name, p in a.named_parameters():
        if ".norm" in name and name.endswith("weight"):
            assert torch.all(p == 1), name
