"""Torch port: the ResNet and VGG backbones and BatchNorm against the JAX package.

Each case builds the flax module and its port, carries the JAX params and
``batch_stats`` across with ``weights.from_jax_params``, and feeds both the
same numpy grid (seeded):

- eval mode with running statistics that are not 0 / 1 (those a train-mode
  apply of the JAX module leaves after one batch of another grid);
- train mode: the outputs and the running statistics after the update,
  which must follow flax's rule -- momentum 0.9 (torch's 0.1) with the
  *biased* batch variance -- where torch's own BatchNorm would take the
  unbiased one (33% off over 4 values, as at ``resnet_tiny``'s stage 3).

Tolerances (f32): eval outputs within 1e-5 of the level's largest value.
Train mode divides by batch statistics that E[x^2] - E[x]^2 computes in
f32 from few values in the deep stages (2 a channel at stage 3 of a 32^3
batch of 2): the two packages' sums of different order differ by an ulp
of E[x^2], which a small variance and ``rsqrt(var + 1e-5)`` (up to 316x)
carry into the output.  The two scenes of a batch are made unlike (two
draws of one noise give near-equal deep features, whose variance is all
rounding), and train outputs hold to 5e-4 of the level's largest (the
worst measured is 1.2e-4, ``resnet_tiny`` at 32^3) and the running
statistics to 1e-4 of each leaf's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from nerf_rpn_tpu.models import resnet as jresnet
from nerf_rpn_tpu.models import vgg as jvgg
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.models import resnet, vgg
from nerf_rpn_tpu_torch.models.layers import batch_norm, bn3d

TRAIN_TOL = 5e-4

CASES = {
    # name: (flax module, port module, grid shape (B, X, Y, Z))
    "resnet_tiny_32": (lambda: jresnet.ResNetFPN256(layers=(1, 1, 1, 1), base_width=8,
                                                     out_channels=32),
                       lambda: resnet.ResNetFPN256((1, 1, 1, 1), base_width=8,
                                                   out_channels=32), (2, 32, 32, 32)),
    "resnet_tiny_odd": (lambda: jresnet.ResNetFPN256(layers=(1, 1, 1, 1), base_width=8,
                                                      out_channels=32),
                        lambda: resnet.ResNetFPN256((1, 1, 1, 1), base_width=8,
                                                    out_channels=32), (1, 36, 40, 28)),
    "vgg_AF": (lambda: jvgg.VGGFPN(cfg="AF", input_size=160),
               lambda: vgg.VGGFPN("AF", input_size=160), (1, 32, 32, 32)),
    "vgg_DF": (lambda: jvgg.VGGFPN(cfg="DF", input_size=160),
               lambda: vgg.VGGFPN("DF", input_size=160), (1, 32, 32, 32)),
    "vgg_EF": (lambda: jvgg.VGGFPN(cfg="EF", input_size=160),
               lambda: vgg.VGGFPN("EF", input_size=160), (1, 32, 32, 32)),
    "vgg_AF_stride1_stem": (lambda: jvgg.VGGFPN(cfg="AF", input_size=16),
                            lambda: vgg.VGGFPN("AF", input_size=16), (1, 16, 16, 16)),
    "vgg_AF_conv_at_start": (lambda: jvgg.VGGFPN(cfg="AF", input_size=160, conv_at_start=True),
                             lambda: vgg.VGGFPN("AF", input_size=160, conv_at_start=True),
                             (1, 32, 32, 32)),
    "resnet_fpn64": (lambda: jresnet.ResNetFPN64(layers=(1, 1, 1, 1)),
                     lambda: resnet.ResNetFPN64((1, 1, 1, 1)), (1, 13, 10, 7)),
    "resnet_simplified": (lambda: jresnet.ResNetSimplified(out_channels=16, num_residuals=2),
                          lambda: resnet.ResNetSimplified(16, 2), (2, 12, 10, 8)),
    "resnet_simplified_s2": (lambda: jresnet.ResNetSimplified(out_channels=16, num_residuals=2,
                                                              stride2_stem=True),
                             lambda: resnet.ResNetSimplified(16, 2, stride2_stem=True),
                             (2, 16, 14, 12)),
}


def _close(got, want, rel, what):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        err = np.abs(g.detach().numpy() - w).max()
        scale = np.abs(w).max()
        assert err <= rel * max(scale, 1e-6), (what, i, err, scale)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jmod, pmod, shape = CASES[request.param]
    rng = np.random.default_rng(len(request.param))
    x = rng.uniform(0, 1, (*shape, 4)).astype(np.float32)
    if shape[0] > 1:  # unlike scenes, so the deep stages' statistics are not near-ties
        x[1] *= np.linspace(0.2, 3.0, shape[1], dtype=np.float32)[:, None, None, None]
        x[1, shape[1] // 4:, : shape[2] // 2, :, 3] += 2.0
    other = rng.uniform(0, 1, (*shape, 4)).astype(np.float32)
    jm = jmod()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, v["params"])
    # running statistics of one train-mode batch of another grid
    _, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(other),
                      train=True, mutable=["batch_stats"])
    stats = jax.tree.map(np.asarray, mut["batch_stats"])
    j_eval = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    j_train, j_mut = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                              train=True, mutable=["batch_stats"])
    port = pmod()
    sd = weights.from_jax_params({"backbone": params}, {"backbone": stats}, port)
    port.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    return dict(name=request.param, x=torch.from_numpy(x), port=port, stats=stats,
                j_eval=j_eval, j_train=j_train,
                j_stats=jax.tree.map(np.asarray, j_mut["batch_stats"]))


def test_eval_mode_matches_jax(case):
    port = case["port"].eval()
    with torch.no_grad():
        got = port(case["x"])
    _close(got, case["j_eval"], 1e-5, case["name"])


def test_train_mode_outputs_and_running_statistics_match_jax(case):
    port = case["port"]
    before = {k: v.clone() for k, v in port.state_dict().items()}
    port.train()
    with torch.no_grad():
        got = port(case["x"])
    after = {k: v.clone() for k, v in port.state_dict().items()}
    port.load_state_dict(before)
    _close(got, case["j_train"], TRAIN_TOL, case["name"])
    have = weights.flatten_tree(weights.to_jax_variables(
        {f"backbone.{k}": v for k, v in after.items()}, port)["batch_stats"])
    want = weights.flatten_tree({"backbone": case["j_stats"]})
    assert set(have) == set(want)
    for k, w in want.items():
        err = np.abs(have[k] - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-6), (k, err)
    # once a call, whatever the backbone
    counts = {int(v) for k, v in after.items() if k.endswith("num_batches_tracked")}
    assert counts == {1}


def test_level_strides_and_widths(case):
    port = case["port"].eval()
    with torch.no_grad():
        feats = port(case["x"])
    grid = case["x"].shape[1:4]
    for f, s in zip(feats, port.strides):
        assert tuple(f.shape[1:4]) == tuple(-(-g // s) for g in grid), (case["name"], s)
        assert f.shape[-1] == port.out_channels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_helper_is_flax_batch_norm(dtype, train):
    """One BatchNorm at resnet_tiny's stage-3 width over 4 values a
    channel (B 4 at 1^3) and over a 3^3 grid: outputs within 1e-6 of the
    largest (f32) or 2 bf16 ulps of it, the running statistics within 1e-6
    relative, and the variance update biased (torch's unbiased one is
    4/3 of it here)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for shape in [(4, 1, 1, 1, 256), (2, 3, 3, 3, 64)]:
        rng = np.random.default_rng(shape[0])
        x = rng.normal(0.5, 2.0, shape).astype(np.float32)
        c = shape[-1]
        params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                  "bias": rng.normal(0, 0.3, c).astype(np.float32)}
        stats = {"mean": rng.normal(0, 0.5, c).astype(np.float32),
                 "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
        jm = fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                           dtype=jdt)
        jx = jnp.asarray(x, jdt)
        if train:
            want, mut = jm.apply({"params": params, "batch_stats": stats}, jx,
                                 mutable=["batch_stats"])
            new = mut["batch_stats"]
        else:
            want, new = jm.apply({"params": params, "batch_stats": stats}, jx), stats
        bn = bn3d(c)
        bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                            "bias": torch.from_numpy(params["bias"]),
                            "running_mean": torch.from_numpy(stats["mean"]),
                            "running_var": torch.from_numpy(stats["var"]),
                            "num_batches_tracked": torch.tensor(0)})
        bn.train(train)
        got = batch_norm(torch.from_numpy(x).to(dtype), bn, dtype)
        assert got.dtype == dtype
        want = np.asarray(jnp.asarray(want, jnp.float32))
        scale = np.abs(want).max()
        tol = 1e-6 * scale if dtype == torch.float32 else 2 * 2.0 ** -7 * scale
        assert np.abs(got.detach().float().numpy() - want).max() <= tol
        for leaf, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
            np.testing.assert_allclose(buf.numpy(), np.asarray(new[leaf]), rtol=1e-6,
                                       atol=1e-7)
        if train:
            xb = torch.from_numpy(x).to(dtype).float().reshape(-1, c)
            n = xb.shape[0]
            biased = xb.var(0, unbiased=False)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       (0.9 * stats["var"] + 0.1 * biased.numpy()),
                                       rtol=1e-5)
            assert n == 4 or n == 54
