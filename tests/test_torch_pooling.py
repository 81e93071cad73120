"""Torch port: the CNN backbones' max pools equal the JAX package's bit for bit.

``ops/pooling.py`` is ``F.max_pool3d`` on the channels-first view of a
channels-last tensor; the JAX forms are the pair-regrouped pools of
``nerf_rpn_tpu/ops/pooling.py`` and, for the ceil-mode pool, the -inf pad
and ``nn.max_pool`` that ``models/vgg.py`` runs by default.  A max is exact,
so the outputs must be equal, f32 and bf16, on odd, even and size-1/2
extents.
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerf_rpn_tpu.ops import pooling as jpool
from nerf_rpn_tpu_torch.ops import pooling

SHAPES = [(1, 8, 8, 8, 4), (2, 7, 9, 6, 3), (1, 13, 10, 11, 5), (1, 1, 2, 1, 3),
          (2, 2, 1, 2, 8), (1, 16, 16, 12, 64)]
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _inputs(shape, dtypes):
    x = np.random.default_rng(sum(shape)).normal(0, 1, shape).astype(np.float32)
    t = torch.from_numpy(x).to(dtypes[0])
    return t, jnp.asarray(x, dtypes[1])


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def _vgg_ceil_pool(x):
    """``models/vgg._ceil_max_pool``'s default form."""
    pads = [(0, s % 2) for s in x.shape[1:4]]
    x = jnp.pad(x, [(0, 0)] + pads + [(0, 0)], constant_values=-jnp.inf)
    return fnn.max_pool(x, (2, 2, 2), strides=(2, 2, 2))


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_ceil_pool_equals_jax(shape, dtypes):
    t, j = _inputs(shape, dtypes)
    got = pooling.max_pool_2x2x2(t, ceil_mode=True)
    assert got.dtype == dtypes[0]
    _equal(got, jpool.max_pool_2x2x2(j, ceil_mode=True))
    _equal(got, _vgg_ceil_pool(j))


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [s for s in SHAPES if min(s[1:4]) >= 2])
def test_floor_pool_equals_jax(shape, dtypes):
    t, j = _inputs(shape, dtypes)
    _equal(pooling.max_pool_2x2x2(t, ceil_mode=False), jpool.max_pool_2x2x2(j, ceil_mode=False))


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_stem_pool_equals_jax(shape, dtypes):
    t, j = _inputs(shape, dtypes)
    got = pooling.stem_pool(t)
    assert got.shape[1:4] == tuple((s - 1) // 2 + 1 for s in shape[1:4])
    assert torch.isfinite(got.float()).all()  # no -inf leaks from the pad
    _equal(got, jpool.max_pool_3x3x3_s2_p1(j))
    _equal(got, fnn.max_pool(j, (3, 3, 3), strides=(2, 2, 2),
                             padding=((1, 1), (1, 1), (1, 1))))


@pytest.mark.parametrize("pool", [(2, 2, 0, True), (2, 2, 0, False), (3, 2, 1, False)],
                         ids=["ceil", "floor", "stem"])
@pytest.mark.parametrize("shape", [s for s in SHAPES if min(s[1:4]) >= 2])
def test_index_put_backward_equals_max_pool3d_backward(shape, pool):
    """The backward that deterministic mode routes the card's pools through
    (``index_put_`` with ``accumulate=True``) gives ``F.max_pool3d``'s
    forward and gradient: within 1e-6 (relative), the sums of up to eight
    windows' gradients in another order."""
    kernel, stride, padding, ceil_mode = pool
    x = torch.from_numpy(np.random.default_rng(sum(shape)).normal(0, 1, shape)
                         .astype(np.float32)).permute(0, 4, 1, 2, 3)
    # ReLU-like ties: a max's gradient goes to one input of the window
    x = x.clamp(min=0).requires_grad_()
    x2 = x.detach().clone().requires_grad_()
    want = F.max_pool3d(x, kernel, stride, padding, ceil_mode=ceil_mode)
    got = pooling._MaxPool3dIndexPut.apply(x2, kernel, stride, padding, ceil_mode)
    assert torch.equal(got, want)
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(1))
    want.backward(g)
    got.backward(g)
    torch.testing.assert_close(x2.grad, x.grad, rtol=1e-6, atol=1e-6)
    assert x.grad.abs().sum() > 0
