"""Torch port: the window-attention backward (kernel K2's plain twin) vs JAX.

The JAX side is ``jax.vjp`` of ``flash_window_attention(..., interpret=True)``,
whose backward is the Pallas kernel ``_flash_bwd_kernel`` run in interpret
mode on the CPU, as ``tests/test_flash_window_attention.py`` runs it.  The
port's autograd function (K1 forward, K2 backward; their twins on CPU
tensors) is also held against ``torch.autograd`` through K1's twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.ops.window_attention import flash_window_attention
from nerf_rpn_tpu_torch import kernels
from nerf_rpn_tpu_torch.ops.window_attention import (
    WindowAttention,
    backward_groups,
    backward_windows,
    window_attention_backward,
    window_attention_backward_reference,
    window_attention_reference,
)


def _inputs(w, h, c, n_w, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(0, 1, (w, 64, 3 * c)).astype(np.float32)
    bias = rng.normal(0, 0.5, (h, 64, 64)).astype(np.float32)
    dout = rng.normal(0, 1, (w, 64, c)).astype(np.float32)
    mask = None
    if n_w:
        mask = np.where(rng.random((n_w, 64, 64)) < 0.2, -100.0, 0.0).astype(np.float32)
    return qkv, dout, bias, mask


def _jax_vjp(qkv, dout, bias, mask, h, dtype):
    w = qkv.shape[0]
    jmask = None if mask is None else jnp.asarray(np.tile(mask, (w // mask.shape[0], 1, 1)), dtype)
    _, vjp = jax.vjp(lambda q, b: flash_window_attention(q, b, jmask, h, 16, True),
                     jnp.asarray(qkv, dtype), jnp.asarray(bias))
    dqkv, dbias = vjp(jnp.asarray(dout, dtype))
    return np.asarray(dqkv.astype(jnp.float32)), np.asarray(dbias)


def _port(qkv, dout, bias, mask, h, dtype):
    dqkv, dbias = window_attention_backward_reference(
        torch.from_numpy(qkv).to(dtype), torch.from_numpy(dout).to(dtype),
        torch.from_numpy(bias), None if mask is None else torch.from_numpy(mask), h)
    assert dqkv.dtype == dtype and dbias.dtype == torch.float32
    return dqkv.float().numpy(), dbias.numpy()


# N = 64; nW divides W; D = 8 (C = 16 / 24) and D = 32 (C = 64 / 96)
CASES = [
    (8, 2, 16, 0),      # D = 8, no shift
    (12, 3, 24, 4),     # D = 8, mask broadcast over 3 scenes
    (16, 2, 64, 8),     # D = 32, mask broadcast over 2 scenes
    (10, 3, 96, 0),     # D = 32, no shift
]


@pytest.mark.parametrize("w,h,c,n_w", CASES)
def test_twin_matches_jax_f32(w, h, c, n_w):
    args = _inputs(w, h, c, n_w)
    want_q, want_b = _jax_vjp(*args, h, jnp.float32)
    got_q, got_b = _port(*args, h, torch.float32)
    assert got_q.shape == (w, 64, 3 * c) and got_b.shape == (h, 64, 64)
    # f32 products and window sums in other orders: 2e-5 of the scale
    np.testing.assert_allclose(got_q, want_q, rtol=0, atol=2e-5 * np.abs(want_q).max())
    np.testing.assert_allclose(got_b, want_b, rtol=0, atol=2e-5 * np.abs(want_b).max())


@pytest.mark.parametrize("w,h,c,n_w", CASES)
def test_twin_matches_jax_bf16(w, h, c, n_w):
    args = _inputs(w, h, c, n_w, seed=1)
    want_q, want_b = _jax_vjp(*args, h, jnp.bfloat16)
    got_q, got_b = _port(*args, h, torch.bfloat16)
    # dqkv within 2 bf16 ulps of the output scale: a probability or a ds
    # rounding to the neighbouring bf16 value moves an output by less
    scale = np.abs(want_q).max()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert np.abs(got_q - want_q).max() <= 2 * ulp
    # dbias sums the unrounded f32 ds: f32 tolerance
    np.testing.assert_allclose(got_b, want_b, rtol=0, atol=2e-5 * np.abs(want_b).max())


@pytest.mark.parametrize("masked", [False, True])
def test_autograd_function_matches_autograd_through_the_twin(masked):
    qkv, dout, bias, mask = _inputs(12, 3, 48, 4 if masked else 0, seed=2)
    mask = None if mask is None else torch.from_numpy(mask)
    grads = []
    for fn in (WindowAttention.apply, window_attention_reference):
        q = torch.from_numpy(qkv).requires_grad_()
        b = torch.from_numpy(bias).requires_grad_()
        out = fn(q, b, mask, 3)
        (out * torch.from_numpy(dout)).sum().backward()
        grads.append((out.detach(), q.grad, b.grad))
    for got, want in zip(*grads):
        # f32: the same math in another order of operations
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_autograd_gives_the_mask_no_gradient():
    qkv, _, bias, mask = _inputs(4, 2, 16, 2, seed=3)
    m = torch.from_numpy(mask).requires_grad_()
    q = torch.from_numpy(qkv).requires_grad_()
    WindowAttention.apply(q, torch.from_numpy(bias), m, 2).sum().backward()
    assert m.grad is None and q.grad is not None


def test_cpu_tensors_take_the_twin_and_launch_nothing():
    qkv, dout, bias, mask = (torch.from_numpy(a) for a in _inputs(8, 2, 16, 4, seed=4))
    before = kernels.counts()["window_attention_bwd"]
    got = window_attention_backward(qkv, dout, bias, mask, 2)
    want = window_attention_backward_reference(qkv, dout, bias, mask, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.counts()["window_attention_bwd"] == before


@pytest.mark.parametrize("w,h", [(2000, 3), (250, 6), (54, 12), (16, 24), (1, 48), (7, 1)])
def test_backward_groups_cover_every_window_once(w, h):
    n_groups = backward_groups(w, h, 32, torch.bfloat16)
    assert 1 <= n_groups <= w
    runs = [backward_windows(r, n_groups, w) for r in range(n_groups)]
    assert [i for run in runs for i in run] == list(range(w))
    assert all(len(run) >= 1 for run in runs)
    # one (64, 64) f32 dbias partial per block: about one wave of blocks
    assert n_groups * h <= max(3 * 132, h)


def test_backward_shape_checks():
    qkv, dout, bias, _ = (None if a is None else torch.from_numpy(a)
                          for a in _inputs(6, 3, 96, 0))
    with pytest.raises(ValueError):
        window_attention_backward_reference(qkv, dout[:, :, :48], bias, None, 3)
    with pytest.raises(ValueError):
        window_attention_backward_reference(qkv, dout, bias, torch.zeros(4, 64, 64), 3)
