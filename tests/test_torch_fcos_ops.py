"""Torch port: the FCOS codecs, targets, losses and inference vs JAX.

The same seeded inputs go through ``nerf_rpn_tpu.models.fcos`` /
``nerf_rpn_tpu.ops.fcos_box`` and the port's ``models/fcos.py`` /
``ops/fcos_box.py`` on a 32^3 mesh with the four FPN levels (585
locations).  Tolerances:

- location tables, padding masks and labels exact;
- codecs, regression targets and centerness f32 rtol 1e-5;
- each loss term rtol 1e-5 and its gradient with respect to the head
  outputs within 1e-4 of the largest entry (f32 sums in another order),
  for AABB {iou, linear_iou, giou, smooth_l1} and OBB {iou, linear_iou,
  giou, diou, smooth_l1}, the OBB cases with the extra L1 on the midpoint
  offsets and the 2D projection loss on;
- inference: keep-sets, levels and counts exact, boxes and scores f32
  rtol 1e-5.

With two gt boxes a scene the losses gather K = 256 < 585 positives, the
path of the train step.  The K-cap case raises the center-sampling radius
until a scene has more positives than K = 128 (one gt box): both packages
keep the same rows (the first K positives in index order), the port
reports the rest as ``dropped_positives``, and at the default radius that
count is 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.models import fcos as jf
from nerf_rpn_tpu.ops import fcos_box as jbox
from nerf_rpn_tpu_torch.models import fcos as pf
from nerf_rpn_tpu_torch.ops import fcos_box as pbox
from nerf_rpn_tpu_torch.ops.topk import safe_top_k

SHAPES = [(8, 8, 8), (4, 4, 4), (2, 2, 2), (1, 1, 1)]
STRIDES = (4, 8, 16, 32)
RTOL = 1e-5
GRAD_TOL = 1e-4


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _close(got, want, rtol=RTOL, atol=1e-6, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _tables():
    loc, lvl, counts, stride_of, soi = jf.fcos_locations(SHAPES, STRIDES)
    return loc, counts, stride_of, soi


def _gt(rng, rotated, b=2, g=3, n_valid=(2, 1)):
    """(B, G, 6|7) gt boxes of 6-14 units (level 0 and 1 sizes), the first
    ``n_valid[i]`` valid in scene i."""
    if rotated:
        gt = np.zeros((b, g, 7), np.float32)
        gt[..., :3] = rng.uniform(9, 23, (b, g, 3))
        gt[..., 3] = rng.uniform(8, 14, (b, g))
        gt[..., 4] = rng.uniform(4, 8, (b, g))
        gt[..., 5] = rng.uniform(6, 12, (b, g))
        gt[..., 6] = rng.uniform(-1.2, 1.2, (b, g))
    else:
        lo = rng.uniform(2, 14, (b, g, 3))
        gt = np.concatenate([lo, lo + rng.uniform(6, 14, (b, g, 3))], -1).astype(np.float32)
    mask = np.zeros((b, g), bool)
    for i, n in enumerate(n_valid):
        mask[i, :n] = True
    gt[~mask] = 0.0
    return gt, mask


def _heads(rng, l_total, reg_dim, b=2):
    cls = rng.normal(-1.0, 1.0, (b, l_total, 1)).astype(np.float32)
    reg = np.abs(rng.normal(1.0, 0.6, (b, l_total, reg_dim))).astype(np.float32)
    if reg_dim == 8:  # the midpoint offsets lie in [-0.5, 0.5]
        reg[..., 6:] = rng.uniform(-0.45, 0.45, (b, l_total, 2))
    ctr = rng.normal(0.0, 1.0, (b, l_total, 1)).astype(np.float32)
    return cls, reg, ctr


def test_location_tables_flatten_and_padding_mask():
    loc, counts, stride_of, soi = _tables()
    got = pf.fcos_locations(SHAPES, STRIDES)
    for g, w in zip(got, jf.fcos_locations(SHAPES, STRIDES)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert sum(counts) == 585
    ori = np.array([[30, 32, 20], [32, 17, 32]], np.int32)
    want = np.asarray(jf.fcos_padding_mask(loc, jnp.asarray(ori)))
    np.testing.assert_array_equal(pf.fcos_padding_mask(_t(loc), _t(ori)).numpy(), want)
    assert 0 < want.sum() < want.size
    rng = np.random.default_rng(0)
    per_level = [rng.normal(size=(2, *s, 8)).astype(np.float32) for s in SHAPES]
    np.testing.assert_array_equal(
        pf.flatten_fcos_outputs([_t(p) for p in per_level], 8).numpy(),
        np.asarray(jf.flatten_fcos_outputs([jnp.asarray(p) for p in per_level], 8)))


def test_codecs():
    rng = np.random.default_rng(1)
    n = 64
    loc = rng.uniform(4, 28, (n, 3)).astype(np.float32)
    lo = rng.uniform(0, 12, (n, 3))
    aabb = np.concatenate([lo, lo + rng.uniform(4, 16, (n, 3))], -1).astype(np.float32)
    _close(pbox.encode_fcos_aabb(_t(loc), _t(aabb)), jbox.encode_fcos_aabb(loc, aabb))
    dist = np.abs(rng.normal(3, 2, (n, 6))).astype(np.float32)
    _close(pbox.decode_fcos_aabb(_t(loc), _t(dist)), jbox.decode_fcos_aabb(loc, dist))
    obb, _ = _gt(rng, True, b=1, g=n, n_valid=(n,))
    obb = obb[0]
    obb[:4, 6] = 0.0  # the axis-aligned fallback
    enc = pbox.encode_fcos_obb(_t(loc), _t(obb))
    jenc = jbox.encode_fcos_obb(jnp.asarray(loc), jnp.asarray(obb))
    _close(enc, jenc, atol=1e-5)
    reg = np.concatenate([dist, rng.uniform(-0.5, 0.5, (n, 2))], -1).astype(np.float32)
    reg[:3] = 0.0  # degenerate: zero-length vectors through safe_norm
    _close(pbox.decode_fcos_obb(_t(loc), _t(reg)), jbox.decode_fcos_obb(loc, reg), atol=1e-5)


@pytest.mark.parametrize("rotated", [False, True])
def test_targets_and_centerness(rotated):
    loc, counts, stride_of, soi = _tables()
    rng = np.random.default_rng(2)
    gt, mask = _gt(rng, rotated)
    # a duplicate gt: equal volumes, the lower index must win the location
    gt[0, 1] = gt[0, 0]
    cfg = jf.FCOSConfig(rotated=rotated, fpn_strides=STRIDES)
    pcfg = pf.FCOSConfig(rotated=rotated, fpn_strides=STRIDES)
    for i in range(2):
        labels, reg = jf.fcos_targets_single(cfg, jnp.asarray(loc), jnp.asarray(stride_of),
                                             jnp.asarray(soi), jnp.asarray(gt[i]),
                                             jnp.asarray(mask[i]))
        got_l, got_r = pf.fcos_targets_single(pcfg, _t(loc), _t(stride_of), _t(soi),
                                              _t(gt[i]), _t(mask[i]))
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(labels))
        assert np.asarray(labels).sum() > 0
        pos = np.asarray(labels) > 0
        _close(got_r.numpy()[pos], np.asarray(reg)[pos], atol=1e-5)
        _close(pf.compute_centerness_targets(got_r[torch.from_numpy(pos)]),
               jf.compute_centerness_targets(jnp.asarray(reg)[pos]))
    # off the positives (negative distances) the clip keeps it finite
    dist = rng.normal(1.0, 1.0, (100, 6)).astype(np.float32)
    _close(pf.compute_centerness_targets(_t(dist)),
           jf.compute_centerness_targets(jnp.asarray(dist)))


LOSS_CASES = [(False, t) for t in ("iou", "linear_iou", "giou", "smooth_l1")] + [
    (True, t) for t in ("iou", "linear_iou", "giou", "diou", "smooth_l1")]


@pytest.mark.parametrize("rotated,loss_type", LOSS_CASES)
def test_losses_and_gradients(rotated, loss_type):
    loc, counts, stride_of, soi = _tables()
    rng = np.random.default_rng(3)
    gt, mask = _gt(rng, rotated)
    cls, reg, ctr = _heads(rng, len(loc), 8 if rotated else 6)
    ori = np.array([[32, 30, 32], [28, 32, 32]], np.int32)
    kw = dict(rotated=rotated, fpn_strides=STRIDES, iou_loss_type=loss_type,
              use_additional_l1_loss=rotated, proj2d_loss_weight=0.5 if rotated else 0.0)
    jcfg, pcfg = jf.FCOSConfig(**kw), pf.FCOSConfig(**kw)
    pad = np.asarray(jf.fcos_padding_mask(loc, jnp.asarray(ori)))

    def jax_total(c, r, t):
        out = jf.fcos_losses(jcfg, c, r, t, jnp.asarray(loc), jnp.asarray(stride_of),
                             jnp.asarray(soi), jnp.asarray(gt), jnp.asarray(mask),
                             padding_mask=jnp.asarray(pad))
        return out["loss_cls"] + out["loss_reg"] + out["loss_centerness"], out

    (_, want), jgrads = jax.value_and_grad(jax_total, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(ctr))
    inputs = [_t(x, grad=True) for x in (cls, reg, ctr)]
    got = pf.fcos_losses(pcfg, *inputs, _t(loc), _t(stride_of), _t(soi), _t(gt), _t(mask),
                         padding_mask=_t(pad))
    assert set(got) == set(want) | {"dropped_positives"}
    assert float(got["dropped_positives"]) == 0.0
    for k, w in want.items():
        assert np.isfinite(float(w)) and float(w) > 0, k
        _close(got[k], w, atol=0, msg=k)
    (got["loss_cls"] + got["loss_reg"] + got["loss_centerness"]).backward()
    for x, g, name in zip(inputs, jgrads, ("cls", "reg", "ctr")):
        g = np.asarray(g)
        assert np.isfinite(x.grad.numpy()).all() and np.abs(g).max() > 0, name
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=0,
                                   atol=GRAD_TOL * np.abs(g).max(), err_msg=name)


@pytest.mark.parametrize("rotated", [False, True])
def test_inference(rotated):
    loc, counts, stride_of, soi = _tables()
    rng = np.random.default_rng(4)
    cls, reg, ctr = _heads(rng, len(loc), 8 if rotated else 6)
    reg[..., :6] *= stride_of[None, :, None]  # the head's eval output: x stride
    ori = np.array([[32, 30, 32], [28, 32, 26]], np.int32)
    kw = dict(rotated=rotated, fpn_strides=STRIDES, pre_nms_top_n=200,
              fpn_post_nms_top_n=300, pre_nms_thresh=0.05, min_size=0.5)
    pad = np.asarray(jf.fcos_padding_mask(loc, jnp.asarray(ori)))
    want = jf.fcos_inference(jf.FCOSConfig(**kw), jnp.asarray(cls), jnp.asarray(reg),
                             jnp.asarray(ctr), jnp.asarray(loc), counts, jnp.asarray(ori),
                             padding_mask=jnp.asarray(pad))
    got = pf.fcos_inference(pf.FCOSConfig(**kw), _t(cls), _t(reg), _t(ctr), _t(loc),
                            counts, _t(ori), padding_mask=_t(pad))
    valid = np.asarray(want["valid"])
    # NMS bites: fewer kept than the 200 + 64 + 8 + 1 candidates
    assert 20 < valid.sum(axis=1).min() and valid.sum(axis=1).max() < 273
    for k in ("valid", "level_idx"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert set(np.asarray(want["level_idx"])[valid].tolist()) >= {0, 1}
    _close(got["scores"], want["scores"])
    _close(got["boxes"].numpy()[valid], np.asarray(want["boxes"])[valid], atol=1e-5)
    vox_c = [rng.normal(size=(2, *s, 1)).astype(np.float32) for s in SHAPES]
    vox_t = [rng.normal(size=(2, *s, 1)).astype(np.float32) for s in SHAPES]
    for g, w in zip(pf.fcos_voxel_scores([_t(c) for c in vox_c], [_t(t) for t in vox_t]),
                    jf.fcos_voxel_scores([jnp.asarray(c) for c in vox_c],
                                         [jnp.asarray(t) for t in vox_t])):
        _close(g, w)


@pytest.mark.parametrize("radius,dropped", [(8.0, True), (1.5, False)])
def test_positive_capacity(radius, dropped):
    """One gt box a scene (K = 128) that fills a 192^3 mesh: level 3
    (stride 32, no upper size bound) holds 216 locations inside it.  At
    radius 8 the center-sampling region covers the box, so a scene has more
    than K positives, and both packages keep the first K in index order; at
    the default 1.5 none is dropped."""
    shapes = [(48,) * 3, (24,) * 3, (12,) * 3, (6,) * 3]
    loc, _, counts, stride_of, soi = jf.fcos_locations(shapes, STRIDES)
    rng = np.random.default_rng(5)
    gt = np.array([[[2, 4, 3, 190, 188, 189]], [[10, 0, 6, 180, 192, 170]]], np.float32)
    mask = np.ones((2, 1), bool)
    cls, reg, ctr = _heads(rng, len(loc), 6)
    kw = dict(fpn_strides=STRIDES, center_sampling_radius=radius, iou_loss_type="giou")
    jcfg = jf.FCOSConfig(**kw)
    labels = np.stack([np.asarray(jf.fcos_targets_single(
        jcfg, jnp.asarray(loc), jnp.asarray(stride_of), jnp.asarray(soi),
        jnp.asarray(gt[i]), jnp.asarray(mask[i]))[0]) for i in range(2)]) > 0
    n_pos, k = labels.sum(axis=1), 128
    assert (n_pos.min() > k) == dropped and n_pos.min() > 0, n_pos
    # the rows both keep: lax.top_k's and the port's order of the 0/1 vector
    _, jidx = jax.lax.top_k(jnp.asarray(labels, jnp.float32), k)
    _, pidx = safe_top_k(torch.from_numpy(labels).float(), k)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    want = jf.fcos_losses(jcfg, jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(ctr),
                          jnp.asarray(loc), jnp.asarray(stride_of), jnp.asarray(soi),
                          jnp.asarray(gt), jnp.asarray(mask))
    got = pf.fcos_losses(pf.FCOSConfig(**kw), _t(cls), _t(reg), _t(ctr), _t(loc),
                         _t(stride_of), _t(soi), _t(gt), _t(mask))
    for key, w in want.items():
        _close(got[key], w, atol=0, msg=key)
    assert float(got["dropped_positives"]) == float(np.maximum(n_pos - k, 0).sum())
