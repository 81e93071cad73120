"""Torch port: kernel K6's twin against the JAX kernel (Pallas, interpret).

The same numpy tokens and parameters (non-trivial LayerNorm affine and
biases) go through ``nerf_rpn_tpu.ops.fused_mlp.fused_mlp_block``
(``interpret=True``, tile 256, T = 300 tokens: not a multiple of the tile)
and through the port's ``fused_mlp_block`` on CPU tensors (its plain twin).
f32: atol/rtol 1e-5.  bf16: within 2 bf16 ulps of each JAX output element
(the rounding points are the same; the f32 sums run in other orders).  XLA
on the CPU drops the rounding of bf16 intermediates by default
(``xla_allow_excess_precision``: here the bf16 ``h + b1`` before the
GELU), so the JAX kernel is compiled with that option off and keeps the
rounding points that it states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.ops.fused_mlp import fused_mlp_block as jax_mlp
from nerf_rpn_tpu_torch.ops.fused_mlp import _erf_as7126, fused_mlp_block


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _inputs(t, c, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0.2, 1, (t, c)).astype(np.float32),
            rng.normal(1, 0.2, c).astype(np.float32),
            rng.normal(0, 0.2, c).astype(np.float32),
            (rng.normal(0, 1, (c, hd)) * c ** -0.5).astype(np.float32),
            rng.normal(0, 0.3, hd).astype(np.float32),
            (rng.normal(0, 1, (hd, c)) * hd ** -0.5).astype(np.float32),
            rng.normal(0, 0.3, c).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_jax_kernel_interpret(dtype):
    args = _inputs(300, 32, 128)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = (jnp.asarray(args[0]).astype(jd), *map(jnp.asarray, args[1:]))
    want = jax_mlp.lower(*jargs, tile=256, interpret=True).compile(
        compiler_options={"xla_allow_excess_precision": False})(*jargs)
    want = np.asarray(want.astype(jnp.float32))
    got = fused_mlp_block(torch.from_numpy(args[0]).to(td), *map(torch.from_numpy, args[1:]))
    assert got.dtype == td and got.shape == want.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= 2 * bf16_ulp(want))


def test_erf_is_the_jax_kernels_polynomial():
    from nerf_rpn_tpu.ops.fused_mlp import _erf_f32

    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    # same polynomial; exp implementations differ by an ulp: 1e-6
    np.testing.assert_allclose(_erf_as7126(torch.from_numpy(x)).numpy(),
                               np.asarray(_erf_f32(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_bad_shapes_raise():
    args = [torch.from_numpy(a) for a in _inputs(8, 16, 64)]
    with pytest.raises(ValueError):
        fused_mlp_block(args[0][None], *args[1:])
    with pytest.raises(ValueError):
        fused_mlp_block(*args[:3], args[3][:, :32], *args[4:])
