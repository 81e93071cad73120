"""Torch port: weights, BatchNorm statistics and initialisation of the CNN backbones.

- ``weights.to_jax_variables`` of a port ``state_dict`` has the JAX
  module's tree (every path and shape of ``params`` and ``batch_stats``,
  from ``jax.eval_shape`` of its ``init``), and ``from_jax_params`` brings
  it back exactly, for every backbone of the driver table and the others;
- the backbone part of a port ``state_dict`` through the JAX package's
  ``tools/convert_weights.convert_backbone`` equals ``to_jax_variables``;
- ``init_params`` starts every BatchNorm at weight 1, bias 0, running mean
  0 and variance 1, and draws the convs from flax's laws;
- ``run_rpn --check_arch`` counts flax's ``params``;
- AdamW decays the BatchNorm scales and biases, and leaves the buffers;
- a ``save_npz`` file with ``batch_stats`` loads through ``--weights``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.models import resnet as jresnet
from nerf_rpn_tpu.models import vgg as jvgg
from nerf_rpn_tpu.models.nerf_rpn import NeRFRPN as JNeRFRPN
from nerf_rpn_tpu.tools import convert_weights
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.cli import run_rpn
from nerf_rpn_tpu_torch.models import resnet, vgg
from nerf_rpn_tpu_torch.models.nerf_rpn import TRUNCATED_STD, NeRFRPN, init_params
from nerf_rpn_tpu_torch.train.state import TrainState

BACKBONES = {
    # name: (flax module, port module, convert_backbone arguments)
    # resnet's block layout at a small width: blocks past the first of a
    # stage have no downsample
    "resnet_2111": (lambda: jresnet.ResNetFPN256(layers=(2, 1, 1, 1), base_width=8,
                                                 out_channels=16),
                    lambda: resnet.ResNetFPN256((2, 1, 1, 1), base_width=8, out_channels=16),
                    ("resnet", {"layers": (2, 1, 1, 1)})),
    "resnet_tiny": (lambda: jresnet.ResNetFPN256(layers=(1, 1, 1, 1), base_width=8,
                                                 out_channels=32),
                    lambda: resnet.ResNetFPN256((1, 1, 1, 1), base_width=8, out_channels=32),
                    ("resnet", {"layers": (1, 1, 1, 1)})),
    "vgg_AF": (lambda: jvgg.VGGFPN(cfg="AF"), lambda: vgg.VGGFPN("AF"),
               ("vgg_AF", {"input_size": 160})),
    "vgg_EF": (lambda: jvgg.VGGFPN(cfg="EF"), lambda: vgg.VGGFPN("EF"),
               ("vgg_EF", {"input_size": 160})),
    "vgg_DF_small": (lambda: jvgg.VGGFPN(cfg="DF", input_size=32),
                     lambda: vgg.VGGFPN("DF", input_size=32),
                     ("vgg_DF", {"input_size": 32})),
    "vgg_AF_conv_at_start": (lambda: jvgg.VGGFPN(cfg="AF", conv_at_start=True),
                             lambda: vgg.VGGFPN("AF", conv_at_start=True),
                             ("vgg_AF", {"input_size": 160, "conv_at_start": True})),
    "vgg_AF_no_bn": (lambda: jvgg.VGGFPN(cfg="AF", batch_norm=False),
                     lambda: vgg.VGGFPN("AF", batch_norm=False),
                     ("vgg_AF", {"input_size": 160, "batch_norm": False})),
    "resnet_fpn64": (lambda: jresnet.ResNetFPN64(), lambda: resnet.ResNetFPN64(), None),
    "resnet_simplified": (lambda: jresnet.ResNetSimplified(stride2_stem=True),
                          lambda: resnet.ResNetSimplified(stride2_stem=True), None),
}


def _flax_shapes(module, grid=(1, 32, 32, 32, 4)):
    """Path -> shape of the ``params`` and ``batch_stats`` of ``module.init``
    (traced, not run)."""
    v = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(grid)))
    return {k: {tuple(e.key for e in path): tuple(leaf.shape)
                for path, leaf in jax.tree_util.tree_leaves_with_path(v.get(k, {}))}
            for k in ("params", "batch_stats")}


def _port(name):
    """The port module with torch's default weights and running
    statistics that are not 0 / 1."""
    torch.manual_seed(0)
    port = BACKBONES[name][1]()
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.uniform_(-1, 1)
                m.running_var.uniform_(0.5, 2)
    return port


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_round_trip_has_the_jax_tree(name):
    port = _port(name)
    sd = {f"backbone.{k}": v for k, v in port.state_dict().items()}
    variables = weights.to_jax_variables(sd, port)
    have = {k: {p: v.shape for p, v in weights.flatten_tree(variables[k]).items()}
            for k in ("params", "batch_stats")}
    want = _flax_shapes(BACKBONES[name][0]())
    for k in ("params", "batch_stats"):
        assert have[k] == {("backbone", *p): s for p, s in want[k].items()}, k
    back = weights.from_jax_params(variables["params"], variables["batch_stats"], port)
    assert set(back) == set(sd)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            assert int(back[k]) == 0
        else:
            assert torch.equal(back[k], v), k


@pytest.mark.parametrize("name", sorted(k for k, v in BACKBONES.items() if v[2]))
def test_to_jax_equals_the_jax_packages_converter(name):
    port = _port(name)
    kind, kw = BACKBONES[name][2]
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = convert_weights.convert_backbone(sd, kind, **kw)
    mine = weights.to_jax_variables({f"backbone.{k}": v for k, v in port.state_dict().items()},
                                    port)
    for got, want in ((mine["params"]["backbone"], params),
                      (mine["batch_stats"].get("backbone", {}), stats)):
        got, want = weights.flatten_tree(got), weights.flatten_tree(want)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_init_params_starts_batch_norms_at_flax_values():
    model = NeRFRPN("resnet_tiny", conv_depth=1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.fill_(3.0)
                m.num_batches_tracked.fill_(7)
    init_params(model, torch.Generator().manual_seed(0))
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm3d)]
    assert len(bns) == 1 + 4 * 4  # stem, then 3 + downsample a block
    for m in bns:
        assert torch.all(m.weight == 1) and torch.all(m.bias == 0)
        assert torch.all(m.running_mean == 0) and torch.all(m.running_var == 1)
        assert int(m.num_batches_tracked) == 0
    # conv kernels: flax lecun_normal (cut at 2 sigma); conv biases 0
    w = model.backbone.layers[0][0].conv2.weight  # 8 -> 8, 3^3: fan_in 216
    bound = 2.0 / (TRUNCATED_STD * math.sqrt(216))
    assert w.abs().max().item() <= bound * (1 + 1e-6)
    np.testing.assert_allclose(w.std().item(), 1 / math.sqrt(216), rtol=0.15)
    assert torch.all(model.backbone.latlayers[0].bias == 0)
    assert torch.all(model.backbone.smooths[0].bias == 0)
    v = vgg.VGGFPN("AF")
    init_params(v, torch.Generator().manual_seed(1))
    assert torch.all(v.layers[0].bias == 0) and torch.all(v.layers[1].weight == 1)


@pytest.mark.parametrize("backbone", ["resnet", "resnet_tiny", "vgg_AF", "vgg_EF"])
def test_check_arch_counts_flax_params(backbone):
    """``--check_arch``'s count (``Trainer.param_count``: the model's
    parameters) equals flax's count of ``params`` at the driver's defaults;
    the wide models are counted on the meta device, ``resnet_tiny``
    through the CLI."""
    jm = JNeRFRPN(backbone_type=backbone, resolution=160, conv_depth=4)
    want = sum(math.prod(s) for s in _flax_shapes(jm, (1, 64, 64, 64, 4))["params"].values())
    with torch.device("meta"):
        model = NeRFRPN(backbone, conv_depth=4, resolution=160)
    assert sum(p.numel() for p in model.parameters()) == want
    if backbone == "resnet_tiny":
        n = run_rpn.main(["--check_arch", "--backbone_type", backbone, "--device", "cpu"])
        assert n == want


def test_adamw_decays_batch_norm_scales_and_biases_not_buffers():
    model = NeRFRPN("resnet_tiny", conv_depth=1)
    init_params(model, torch.Generator().manual_seed(0))
    state = TrainState(model, lr=1e-3, total_steps=10, weight_decay=0.5)
    bn = model.backbone.bn1
    assert any(p is bn.weight for p in state.params) and any(p is bn.bias for p in state.params)
    assert not any(p is bn.running_var for p in state.params)
    with torch.no_grad():
        bn.bias.fill_(0.5)
    for p in state.params:
        p.grad = torch.zeros_like(p)
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    state.apply_gradients()
    lr0 = 1e-3 / 25  # the one-cycle schedule's first rate
    np.testing.assert_allclose(bn.weight.detach().numpy(), 1 - lr0 * 0.5, rtol=1e-6)
    np.testing.assert_allclose(bn.bias.detach().numpy(), 0.5 * (1 - lr0 * 0.5), rtol=1e-6)
    assert all(torch.equal(v, buffers[k]) for k, v in model.named_buffers())


def test_weights_npz_carries_batch_stats(tmp_path):
    model = NeRFRPN("resnet_tiny", conv_depth=1)
    init_params(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.backbone.bn1.running_var.uniform_(0.5, 2)
    v = weights.to_jax_variables(model.state_dict(), model.backbone)
    path = str(tmp_path / "w.npz")
    weights.save_npz(path, v["params"], v["batch_stats"])
    params, stats = weights.load_variables(path)
    assert "backbone" in stats and "rpn_head" in params
    other = NeRFRPN("resnet_tiny", conv_depth=1)
    weights.load_weights_npz(other, path)
    for k, t in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(other.state_dict()[k], t), k
    # a params-only file (the format of a model without BatchNorms) cannot
    # fill the statistics: strict loading refuses it
    weights.save_npz(str(tmp_path / "p.npz"), v["params"])
    with pytest.raises(RuntimeError, match="running_mean"):
        weights.load_weights_npz(other, str(tmp_path / "p.npz"))
