"""Torch port: the differentiable rotated-IoU chain (``ops/rotated_iou.py``) vs JAX.

The same seeded f32 OBB pairs go through ``nerf_rpn_tpu.ops.rotated_iou``
and the port's module: 2D and 3D IoU, the ``verbose`` 5-tuple that the
RPN's IoU loss reads, the three enclosing boxes, and GIoU / DIoU under
each.  Values within f32 rtol 1e-5 (atol 1e-6 for values near 0);
gradients against ``jax.grad`` within 1e-4 of each input's largest
gradient.  The degenerate boxes of an untrained FCOS head (negative
distances decoded by ``decode_fcos_obb``) must give finite gradients.
Two stated exceptions to the tolerances:

- ``pca``: its eigenvector is ``(a - b - delta) / 2c``, a difference that
  cancels when one axis of the 8 corners dominates (a disjoint pair).  The
  JAX module asks for float64 there, which JAX without x64 keeps at f32,
  so both packages compute it in f32, and a 1e-7 relative difference of
  the covariance (another summation order) moves w, h by up to 2e-4 and
  the gradient by up to 3e-4 of its scale: rtol 1e-3 for this strategy.
- ``smallest``: two perpendicular hull edges of a rectangle enclose it
  with equal area in exact arithmetic; rounding picks one or the other,
  which swaps w and h.  Both losses read only w * h and w^2 + h^2, so the
  test compares the sorted (w, h).

A box and its copy turned by 90 degrees with w and l swapped is the case
where the JAX chain returns an impossible IoU of 1.0055 (ROADMAP.md, "The
JAX package's general rotated IoU can exceed 1"): the port's chain sorts
the same keys and returns the same value there.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.ops import rotated_iou as jri
from nerf_rpn_tpu.ops.fcos_box import decode_fcos_obb as jax_decode_obb
from nerf_rpn_tpu_torch.ops import rotated_iou as ri
from nerf_rpn_tpu_torch.ops.fcos_box import decode_fcos_obb

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-4
ENCLOSING = ("aligned", "pca", "smallest")


def _pairs(seed=0, n=64):
    """Random OBB pairs, most of them overlapping, plus named cases:
    identical, nested, disjoint, a 90-degree turn with sizes swapped and a
    45-degree cross."""
    rng = np.random.default_rng(seed)
    b1 = np.concatenate([rng.uniform(0, 10, (n, 3)), rng.uniform(1, 6, (n, 3)),
                         rng.uniform(-math.pi / 2, math.pi / 2, (n, 1))], -1)
    b2 = b1 + np.concatenate([rng.normal(0, 1.5, (n, 3)), rng.normal(0, 0.8, (n, 3)),
                              rng.normal(0, 0.5, (n, 1))], -1)
    b2[:, 3:6] = np.abs(b2[:, 3:6]) + 0.5
    base = np.array([10.0, 12.0, 5.0, 6.0, 4.0, 2.0, 0.3])
    inner = base.copy()
    inner[3:6] *= 0.5
    far = base.copy()
    far[0] += 50.0
    tilt = np.array([0.0, 0.0, 0.0, 4.0, 2.0, 2.0, math.pi / 4])
    flat = tilt.copy()
    flat[6] = 0.0
    named1 = np.stack([base, base, base, flat])
    named2 = np.stack([base, inner, far, tilt])
    return (np.concatenate([b1, named1]).astype(np.float32),
            np.concatenate([b2, named2]).astype(np.float32))


def _j(x):
    return jnp.asarray(x)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()) if torch.is_tensor(got) else got,
                               np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def test_corners_and_iou_2d():
    b1, b2 = _pairs()
    s1 = np.concatenate([b1[:, 0:2], b1[:, 3:5], b1[:, 6:7]], -1)
    s2 = np.concatenate([b2[:, 0:2], b2[:, 3:5], b2[:, 6:7]], -1)
    _close(ri.box2corners(_t(s1)), jri.box2corners(_j(s1)))
    got = ri.iou_rotated_2d(_t(s1), _t(s2))
    want = jri.iou_rotated_2d(_j(s1), _j(s2))
    for g, w, name in zip(got, want, ("iou", "corners1", "corners2", "union")):
        _close(g, w, msg=name)
    inter = ri.oriented_box_intersection_area(ri.box2corners(_t(s1)), ri.box2corners(_t(s2)))
    assert float(inter.min()) >= 0 and int((inter > 0).sum()) > 40


def test_iou_3d_and_the_verbose_tuple():
    b1, b2 = _pairs(1)
    _close(ri.iou_rotated_3d(_t(b1), _t(b2)), jri.iou_rotated_3d(_j(b1), _j(b2)))
    got = ri.iou_rotated_3d(_t(b1), _t(b2), verbose=True)
    want = jri.iou_rotated_3d(_j(b1), _j(b2), verbose=True)
    assert len(got) == len(want) == 5
    for g, w, name in zip(got, want, ("iou3d", "corners1", "corners2", "z_range", "u3d")):
        _close(g, w, msg=name)
    # geometry: identical boxes 1, nested 1/8, disjoint 0
    iou = got[0].detach().numpy()
    np.testing.assert_allclose(iou[-4:-1], [1.0, 0.125, 0.0], atol=1e-5)


@pytest.mark.parametrize("enclosing", ENCLOSING)
def test_enclosing_giou_diou(enclosing):
    b1, b2 = _pairs(2)
    c1 = ri.box2corners(_t(np.concatenate([b1[:, 0:2], b1[:, 3:5], b1[:, 6:7]], -1)))
    c2 = ri.box2corners(_t(np.concatenate([b2[:, 0:2], b2[:, 3:5], b2[:, 6:7]], -1)))
    w, h = ri.enclosing_box(c1, c2, enclosing)
    jw, jh = jri.enclosing_box(_j(c1.numpy()), _j(c2.numpy()), enclosing)
    w, h, jw, jh = (np.asarray(x) for x in (w, h, jw, jh))
    if enclosing == "smallest":  # the same rectangle: (w, h) up to order
        w, h, jw, jh = np.minimum(w, h), np.maximum(w, h), np.minimum(jw, jh), np.maximum(jw, jh)
    rtol = 1e-3 if enclosing == "pca" else RTOL
    _close(w, jw, rtol=rtol, msg="w")
    _close(h, jh, rtol=rtol, msg="h")
    g = ri.giou_rotated_3d(_t(b1), _t(b2), enclosing)
    jg = jri.giou_rotated_3d(_j(b1), _j(b2), enclosing)
    for a, b, name in zip(g, jg, ("giou_loss", "giou", "iou3d")):
        _close(a, b, rtol=rtol, msg=name)
    d = ri.diou_rotated_3d(_t(b1), _t(b2), enclosing)
    jd = jri.diou_rotated_3d(_j(b1), _j(b2), enclosing)
    for a, b, name in zip(d, jd, ("diou_loss", "iou3d")):
        _close(a, b, rtol=rtol, msg=name)


def _grads(fn_t, fn_j, b1, b2):
    x = _t(b1, grad=True)
    fn_t(x, _t(b2)).sum().backward()
    want = jax.grad(lambda p: jnp.sum(fn_j(p, _j(b2))))(_j(b1))
    return x.grad.numpy(), np.asarray(want)


@pytest.mark.parametrize("name,fn_t,fn_j", [
    ("iou3d", ri.iou_rotated_3d, jri.iou_rotated_3d),
    ("giou_smallest", lambda a, b: ri.giou_rotated_3d(a, b)[0],
     lambda a, b: jri.giou_rotated_3d(a, b)[0]),
    ("giou_pca", lambda a, b: ri.giou_rotated_3d(a, b, "pca")[0],
     lambda a, b: jri.giou_rotated_3d(a, b, "pca")[0]),
    ("diou_aligned", lambda a, b: ri.diou_rotated_3d(a, b, "aligned")[0],
     lambda a, b: jri.diou_rotated_3d(a, b, "aligned")[0]),
    ("diou_smallest", lambda a, b: ri.diou_rotated_3d(a, b)[0],
     lambda a, b: jri.diou_rotated_3d(a, b)[0]),
])
def test_gradients_match_jax(name, fn_t, fn_j):
    b1, b2 = _pairs(3)
    got, want = _grads(fn_t, fn_j, b1, b2)
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    # 1e-4 of the largest gradient entry: f32 sums in another order
    # (pca: 1e-3, its cancelling eigenvector, as the module docstring says)
    scale = np.abs(want).max()
    tol = 1e-3 if "pca" in name else GRAD_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


def test_degenerate_boxes_give_finite_gradients():
    """Negative distances straight out of an untrained FCOS head decode to
    degenerate OBBs: every loss of the chain keeps a finite gradient."""
    rng = np.random.default_rng(0)
    regs = rng.normal(0, 2, (256, 8)).astype(np.float32)
    tgts = np.abs(rng.normal(2, 1, (256, 8))).astype(np.float32)
    dummy = torch.zeros((256, 3))
    tgt_boxes = decode_fcos_obb(dummy, _t(tgts))
    for fn in (lambda p: ri.iou_rotated_3d(p, tgt_boxes).sum(),
               lambda p: ri.giou_rotated_3d(p, tgt_boxes)[0].sum(),
               lambda p: ri.diou_rotated_3d(p, tgt_boxes)[0].sum()):
        r = _t(regs, grad=True)
        v = fn(decode_fcos_obb(dummy, r))
        v.backward()
        assert torch.isfinite(v) and torch.isfinite(r.grad).all()
    # and the value agrees with JAX on the same degenerate boxes
    jt = jax_decode_obb(jnp.zeros((256, 3)), _j(tgts))
    want = jri.giou_rotated_3d(jax_decode_obb(jnp.zeros((256, 3)), _j(regs)), jt)[0]
    got = ri.giou_rotated_3d(decode_fcos_obb(dummy, _t(regs)), tgt_boxes)[0]
    finite = np.isfinite(np.asarray(want))
    np.testing.assert_array_equal(np.isfinite(got.detach().numpy()), finite)
    _close(got.detach().numpy()[finite], np.asarray(want)[finite], rtol=1e-4, atol=1e-5)


def test_turned_copy_equals_the_jax_chain():
    """The ROADMAP case: rows 10-19 of ``test_torch_rotated_iou.py``'s
    seed-0 boxes against their copies turned by 90 degrees with w and l
    swapped; at row 16 (theta 1.532 against 3.103) the JAX chain gives
    1.0055 instead of 1."""
    rng = np.random.default_rng(0)

    def draw(n):
        ctr = rng.uniform(0, 30.0, (n, 3))
        dims = rng.uniform(2.0, 12.0, (n, 3))
        theta = rng.uniform(-math.pi / 2, math.pi / 2, (n, 1))
        return np.concatenate([ctr, dims, theta], -1).astype(np.float32)

    boxes = draw(120)[10:20]
    turned = boxes.copy()
    turned[:, 6] += math.pi / 2
    turned[:, 3], turned[:, 4] = boxes[:, 4], boxes[:, 3]
    want = np.asarray(jri.iou_rotated_3d(_j(boxes), _j(turned)))
    got = ri.iou_rotated_3d(_t(boxes), _t(turned)).numpy()
    assert want[6] > 1.005  # row 16: the fault is there
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
