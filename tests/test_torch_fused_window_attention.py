"""Torch port: kernel K4's twin against the JAX kernel (Pallas, interpret).

The same numpy q, k, v, bias and a mask table built from a real Swin shift
mask go through ``nerf_rpn_tpu.ops.window_attention.fused_window_attention``
(``interpret=True``, tile 8, W = 12 windows: not a multiple of the tile;
compiled without XLA's excess precision, as the other kernels' tests) and
through the port's ``fused_window_attention`` on CPU tensors (its plain
twin).  f32: atol/rtol 1e-5 (f32 sums in other orders).  bf16: within 2 bf16
ulps of each JAX output element (the inputs are upcast and only the output
is rounded, so the two differ by the f32 summation order alone).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.ops.window_attention import fused_window_attention as jax_fused
from nerf_rpn_tpu_torch.models.swin import shift_attn_mask, shift_mask_patterns
from nerf_rpn_tpu_torch.ops.window_attention import (
    fused_window_attention,
    fused_window_attention_reference,
)

PAD, WINDOW, SHIFT = (8, 8, 12), (4, 4, 4), (2, 2, 2)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def test_pattern_table_reproduces_the_shift_mask():
    table, ids = shift_mask_patterns(PAD, WINDOW, SHIFT)
    mask = shift_attn_mask(PAD, WINDOW, SHIFT)
    assert table.shape[0] <= 8 and ids.dtype == np.int32 and ids.shape == (mask.shape[0],)
    np.testing.assert_array_equal(table[ids], mask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_jax_kernel_interpret(dtype):
    table, ids = shift_mask_patterns(PAD, WINDOW, SHIFT)
    w, h, d = len(ids), 3, 8
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(0, 1, (w, h, 64, d)).astype(np.float32) for _ in range(3))
    bias = rng.normal(0, 0.5, (h, 64, 64)).astype(np.float32)
    jd = getattr(jnp, dtype)
    jargs = (*(jnp.asarray(a).astype(jd) for a in (q, k, v)), jnp.asarray(bias),
             jnp.asarray(table), jnp.asarray(ids))
    want = jax_fused.lower(*jargs, tile=8, interpret=True).compile(
        compiler_options={"xla_allow_excess_precision": False})(*jargs)
    want = np.asarray(want.astype(jnp.float32))
    td = getattr(torch, dtype)
    got = fused_window_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                                 torch.from_numpy(bias), torch.from_numpy(table),
                                 torch.from_numpy(ids))
    assert got.dtype == td and got.shape == (w, h, 64, d)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= 2 * bf16_ulp(want))


def test_twin_takes_strided_views_of_packed_qkv():
    """The eval route passes q, k, v as views of the K5 output."""
    table, ids = shift_mask_patterns(PAD, WINDOW, SHIFT)
    w, h, d = len(ids), 2, 16
    qkv = torch.randn((w, 64, 3 * h * d), generator=torch.Generator().manual_seed(1))
    bias = torch.randn((h, 64, 64), generator=torch.Generator().manual_seed(2))
    q, k, v = qkv.view(w, 64, 3, h, d).permute(2, 0, 3, 1, 4)
    args = (bias, torch.from_numpy(table), torch.from_numpy(ids))
    got = fused_window_attention(q, k, v, *args)
    want = fused_window_attention_reference(q.contiguous(), k.contiguous(), v.contiguous(),
                                            *args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
