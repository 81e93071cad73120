"""Torch port: Swin FPN backbone, its pieces and the weight mapping vs JAX.

A tiny SwinFPN (embed 24, depths (2, 2, 2, 2)) on a non-cubic 36x28x44
grid exercises window padding (9 -> 12), the shift turned off where the
window covers the padded grid (stage 2, 3 -> 4), odd patch merges
(9x7x11 -> 5x4x6) and the 3 -> 2 level upsample.  The JAX backbone takes
its plain attention path on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.models import swin as jswin
from nerf_rpn_tpu.models.fpn import upsample_nearest as jupsample
from nerf_rpn_tpu.ops.activations import erf_gelu as jerf_gelu
from nerf_rpn_tpu.tools.convert_weights import convert_swin_fpn
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.device import resolve_device
from nerf_rpn_tpu_torch.models import swin
from nerf_rpn_tpu_torch.models.fpn import upsample_nearest
from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN, build_backbone
from nerf_rpn_tpu_torch.ops.activations import erf_gelu

TINY = dict(embed_dim=24, depths=(2, 2, 2, 2), num_heads=(3, 3, 6, 6))
GRID = (36, 28, 44)


@pytest.fixture(scope="module")
def tiny_pair():
    """(input, JAX params with noise on every leaf, JAX pyramid)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (1, *GRID, 4)).astype(np.float32)
    model = jswin.SwinFPN(**TINY, stochastic_depth_prob=0.0)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.02, p.shape).astype(np.float32),
        params)
    out = model.apply({"params": params}, jnp.asarray(x))
    return x, params, [np.asarray(o) for o in out]


def _port_backbone(params):
    m = swin.SwinFPN(**TINY)
    sd = weights.from_jax_params({"backbone": params})
    m.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    return m.eval()


def test_swin_fpn_matches_jax_f32(tiny_pair):
    x, params, want = tiny_pair
    with torch.no_grad():
        got = _port_backbone(params)(torch.from_numpy(x))
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        # f32 sums in other orders through ~20 layers: rtol/atol 1e-4
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


def test_convert_swin_fpn_of_port_state_dict_is_the_jax_tree(tiny_pair):
    _, params, _ = tiny_pair
    sd = _port_backbone(params).state_dict()
    conv, _ = convert_swin_fpn({k: v.numpy() for k, v in sd.items()},
                               depths=TINY["depths"])
    want = weights.flatten_tree(params)
    got = weights.flatten_tree(conv)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_weights_round_trip_and_npz(tiny_pair, tmp_path):
    _, params, _ = tiny_pair
    tree = {"backbone": params}
    path = tmp_path / "w.npz"
    weights.save_npz(str(path), tree)
    back = weights.to_jax_params(weights.from_jax_params(weights.load_npz(str(path))))
    want, got = weights.flatten_tree(tree), weights.flatten_tree(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_rpn_head_weight_mapping_matches_model_keys():
    from nerf_rpn_tpu.models.heads import RPNHead3D as JHead

    feats = [jnp.zeros((1, 4, 4, 4, 256))]
    jp = JHead(num_anchors=13, conv_depth=2).init(jax.random.PRNGKey(0), feats)["params"]
    sd = weights.from_jax_params({"rpn_head": jax.tree.map(np.asarray, jp)})
    head = NeRFRPN("swin_t", conv_depth=2).rpn_head
    want = {f"rpn_head.{k}": v.shape for k, v in head.state_dict().items()}
    assert {k: v.shape for k, v in sd.items()} == want


def test_erf_gelu_matches_jax():
    x = np.linspace(-8, 8, 20001, dtype=np.float32)
    got = erf_gelu(torch.from_numpy(x)).numpy()
    # same polynomial; exp implementations differ by an ulp: 1e-6
    np.testing.assert_allclose(got, np.asarray(jerf_gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((7, 7, 5), (13, 13, 9)),
                                     ((3, 2, 3), (5, 4, 6)),
                                     ((4, 4, 4), (8, 8, 8))])
def test_upsample_matches_jax_nearest(src, dst):
    x = np.random.default_rng(1).normal(0, 1, (2, *src, 3)).astype(np.float32)
    got = upsample_nearest(torch.from_numpy(x), dst).numpy()
    np.testing.assert_array_equal(got, np.asarray(jupsample(jnp.asarray(x), dst)))


@pytest.mark.parametrize("pad_size,shift", [((12, 8, 12), (2, 2, 2)),
                                            ((8, 8, 4), (2, 2, 0))])
def test_shift_mask_and_bias_index_match_jax(pad_size, shift):
    w = (4, 4, 4)
    np.testing.assert_array_equal(swin.shift_attn_mask(pad_size, w, shift),
                                  jswin._shift_attn_mask(pad_size, w, shift))
    np.testing.assert_array_equal(swin.relative_position_index(w),
                                  jswin._relative_position_index(w))


def test_window_partition_round_trip_matches_jax():
    x = np.random.default_rng(2).normal(0, 1, (2, 8, 12, 4, 5)).astype(np.float32)
    got = swin.window_partition(torch.from_numpy(x), (4, 4, 4))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jswin._window_partition(jnp.asarray(x), (4, 4, 4))))
    back = swin.window_reverse(got, (4, 4, 4), 2, (8, 12, 4))
    np.testing.assert_array_equal(back.numpy(), x)


def test_unsupported_backbones_raise():
    with pytest.raises(ValueError, match="divisible"):
        build_backbone("swin_b")  # fails to initialise in JAX too
    with pytest.raises(ValueError, match="Unknown"):
        build_backbone("resnet18")


def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
