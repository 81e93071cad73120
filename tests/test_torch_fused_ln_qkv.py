"""Torch port: kernel K5's twin against the JAX kernel and the model chain.

(a) A divisible grid with shift 0: the same numpy inputs through
    ``nerf_rpn_tpu.ops.fused_ln_qkv.ln_partition_qkv`` (``interpret=True``,
    "flat" layout, compiled without XLA's excess precision so that it keeps
    its bf16 rounding points) and the port's ``ln_partition_qkv`` on CPU
    tensors (its plain twin).  f32: atol/rtol 1e-5.  bf16: within 2 bf16
    ulps of each JAX output element (same rounding points; f32 sums in
    other orders).
(b) Pad and shift, which the JAX kernel does not take: the twin against the
    port's train-mode chain (LayerNorm -> pad -> roll -> partition -> qkv
    dense) in f32, atol/rtol 1e-5, on grids that need padding along one or
    all axes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerf_rpn_tpu.ops.fused_ln_qkv import ln_partition_qkv as jax_ln_qkv
from nerf_rpn_tpu_torch.models import swin
from nerf_rpn_tpu_torch.models.layers import dense, layer_norm
from nerf_rpn_tpu_torch.ops.fused_ln_qkv import ln_partition_qkv

WINDOW = (4, 4, 4)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _params(c, rng):
    s = rng.normal(1, 0.2, c).astype(np.float32)
    t = rng.normal(0, 0.2, c).astype(np.float32)
    w = (rng.normal(0, 1, (c, 3 * c)) * c ** -0.5).astype(np.float32)
    b = rng.normal(0, 0.5, 3 * c).astype(np.float32)
    return s, t, w, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 8, 8, 8, 32), (2, 8, 4, 12, 16)])
def test_twin_matches_jax_kernel_interpret(shape, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(0.3, 1.5, shape).astype(np.float32)
    s, t, w, b = _params(shape[-1], rng)
    jd = getattr(jnp, dtype)
    jargs = (jnp.asarray(x).astype(jd), jnp.asarray(s), jnp.asarray(t),
             jnp.asarray(w).astype(jd), jnp.asarray(b))
    want = jax_ln_qkv.lower(*jargs, WINDOW, out_layout="flat", interpret=True).compile(
        compiler_options={"xla_allow_excess_precision": False})(*jargs)
    want = np.asarray(want.astype(jnp.float32))
    td = getattr(torch, dtype)
    got = ln_partition_qkv(torch.from_numpy(x).to(td), torch.from_numpy(s),
                           torch.from_numpy(t), torch.from_numpy(w), torch.from_numpy(b),
                           WINDOW)
    assert got.dtype == td and got.shape == want.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= 2 * bf16_ulp(want))


@pytest.mark.parametrize("size,shift", [((9, 8, 11), (2, 2, 2)),   # pad x and z
                                        ((5, 7, 6), (2, 2, 2)),    # pad all axes
                                        ((9, 8, 11), (0, 0, 0)),   # pad, no shift
                                        ((8, 3, 12), (2, 0, 2))])  # one window in y
def test_pad_and_shift_match_the_model_chain(size, shift):
    rng = np.random.default_rng(2)
    c = 24
    x = torch.from_numpy(rng.normal(0, 1, (2, *size, c)).astype(np.float32))
    attn = swin.ShiftedWindowAttention3D(c, WINDOW, shift, num_heads=3)
    norm = torch.nn.LayerNorm(c)
    with torch.no_grad():
        for p in [*attn.qkv.parameters(), *norm.parameters()]:
            p.copy_(torch.from_numpy(rng.normal(0, 0.5, p.shape).astype(np.float32)))
    pad_size, shift = attn._geometry(size)
    got = ln_partition_qkv(x, norm.weight, norm.bias, attn.qkv.weight.t(), attn.qkv.bias,
                           WINDOW, pad_size, shift)
    # the train-mode chain of ShiftedWindowAttention3D.forward
    h = layer_norm(x, norm, torch.float32)
    pad = [p - s for p, s in zip(pad_size, size)]
    h = F.pad(h, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
    h = torch.roll(h, tuple(-s for s in shift), dims=(1, 2, 3))
    want = dense(swin.window_partition(h, WINDOW), attn.qkv, torch.float32)
    torch.testing.assert_close(got, want.detach(), rtol=1e-5, atol=1e-5)


def test_bad_geometry_raises():
    x = torch.zeros((1, 8, 8, 8, 16))
    p = (torch.ones(16), torch.zeros(16), torch.zeros(16, 48), torch.zeros(48))
    with pytest.raises(ValueError):
        ln_partition_qkv(x, *p, WINDOW, pad_size=(8, 8, 6))
    with pytest.raises(ValueError):
        ln_partition_qkv(x, *p, WINDOW, shift=(8, 0, 0))
