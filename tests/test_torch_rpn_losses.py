"""Torch port: the RPN training losses vs JAX ``rpn_losses``.

JAX's ``rpn_losses(cfg, key, ...)`` samples its anchors with
``sample_balanced_indices(key, matches, ...)``; the test calls that with
the same key to get JAX's indices and feeds them to the port's
``rpn_losses_at``.  Matches, padding masks and gathered delta rows must be
exact; each loss term within 1e-6 relative, with the 2D projection term
off and on.  Batch 2, so the batch-summed normalisers are exercised.  The OBB form
with the rotated IoU losses (``iou``, ``giou``) is held to JAX with its
gradients; the IoU losses on AABBs are refused (JAX computes no AABB IoU
there), and the focal loss of FCOS is held to its JAX form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.models import rpn as jrpn
from nerf_rpn_tpu.ops import rotated_iou as jri
from nerf_rpn_tpu.ops.aabb import pairwise_iou_aabb as jax_iou
from nerf_rpn_tpu.ops.obb import obb2hbb_3d as jax_obb2hbb_3d
from nerf_rpn_tpu.utils import target_assign as jta
from nerf_rpn_tpu.utils.projection import project_points as jax_project
from nerf_rpn_tpu_torch.models import rpn
from nerf_rpn_tpu_torch.utils.losses import bce_with_logits, smooth_l1
from nerf_rpn_tpu_torch.utils.projection import project_points

MESH = (32, 32, 32)
SHAPES = [(8, 8, 8), (4, 4, 4), (2, 2, 2), (1, 1, 1)]
A = 13


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    anchors, _, strides, counts = jrpn.build_level_tables(jrpn.RPNConfig(), MESH, SHAPES)
    anchors = anchors.astype(np.float32)
    b, g = 2, 8
    logits = [rng.normal(0, 1.5, (b, *s, A)).astype(np.float32) for s in SHAPES]
    deltas = [rng.normal(0, 0.3, (b, *s, A * 6)).astype(np.float32) for s in SHAPES]
    # gt boxes around anchor centres, so that every scene has positives
    centres = anchors[rng.choice(len(anchors), (b, g))]
    ctr = 0.5 * (centres[..., :3] + centres[..., 3:])
    size = rng.uniform(3, 14, (b, g, 3))
    gt = np.concatenate([ctr - size / 2, ctr + size / 2], -1).astype(np.float32)
    mask = np.zeros((b, g), bool)
    mask[0, :5] = True
    mask[1, :3] = True
    gt[~mask] = 0.0
    ori = np.array([[30, 28, 32], [32, 32, 20]], np.int32)
    return dict(anchors=anchors, strides=strides, counts=counts, logits=logits,
                deltas=deltas, gt=gt, mask=mask, ori=ori)


def _jax_matches(s, pad):
    out = []
    for i in range(s["gt"].shape[0]):
        iou = jax_iou(jnp.asarray(s["gt"][i]), jnp.asarray(s["anchors"]))
        iou = jnp.where(pad[i][None], iou, -1.0)
        m = jta.match_anchors(iou, jnp.asarray(s["mask"][i]), 0.35, 0.2)
        out.append(jnp.where(pad[i], m, -2))
    return np.array(jnp.stack(out))


def test_padding_matches_and_delta_rows_exact(setup):
    s = setup
    want_pad = np.asarray(jrpn.dynamic_padding_masks(SHAPES, s["strides"], A, jnp.asarray(s["ori"])))
    pad = rpn.dynamic_padding_masks(SHAPES, s["strides"], A, torch.from_numpy(s["ori"]))
    np.testing.assert_array_equal(pad.numpy(), want_pad)
    assert not want_pad.all()
    matches = rpn.assign_anchors(rpn.RPNConfig(), torch.from_numpy(s["anchors"]),
                                 torch.from_numpy(s["gt"]), torch.from_numpy(s["mask"]), pad)
    np.testing.assert_array_equal(matches.numpy(), _jax_matches(s, want_pad))
    idx = np.random.default_rng(1).integers(0, sum(s["counts"]), (2, 100))
    want = jrpn.gather_delta_rows_levels([jnp.asarray(d) for d in s["deltas"]],
                                         jnp.asarray(idx), s["counts"], A, 6)
    got = rpn.gather_delta_rows_levels([torch.from_numpy(d) for d in s["deltas"]],
                                       torch.from_numpy(idx), s["counts"], A, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("w2d", [0.0, 0.5])
def test_losses_with_jax_indices(setup, w2d):
    s = setup
    jcfg = jrpn.RPNConfig(reg_loss_weight_2d=w2d)
    cfg = rpn.RPNConfig(reg_loss_weight_2d=w2d)
    key = jax.random.PRNGKey(3)
    b = s["gt"].shape[0]
    obj = np.concatenate([l.reshape(b, -1) for l in s["logits"]], 1)
    pad = np.asarray(jrpn.dynamic_padding_masks(SHAPES, s["strides"], A, jnp.asarray(s["ori"])))
    want = jrpn.rpn_losses(
        jcfg, key, jnp.asarray(obj), [jnp.asarray(d) for d in s["deltas"]],
        jnp.asarray(s["anchors"]), jnp.asarray(s["gt"]), jnp.asarray(s["mask"]),
        padding_mask=jnp.asarray(pad), max_mesh_dim=32, level_counts=s["counts"],
        anchors_per_loc=A)
    matches = _jax_matches(s, pad)
    indices = [torch.from_numpy(np.array(t)) for t in jta.sample_balanced_indices(
        key, jnp.asarray(matches), 256, 0.5)]
    assert int(indices[1].sum()) > 0 and int(indices[3].sum()) > 0
    got = rpn.rpn_losses_at(
        cfg, torch.from_numpy(obj), [torch.from_numpy(d) for d in s["deltas"]],
        torch.from_numpy(s["anchors"]), torch.from_numpy(s["gt"]),
        torch.from_numpy(matches).long(), indices, max_mesh_dim=32,
        level_counts=s["counts"], anchors_per_loc=A)
    assert set(got) == set(want)
    for k in want:
        w = float(want[k])
        assert np.isfinite(w) and (w > 0 or (k == "loss_rpn_box_reg_2d" and w2d == 0)), k
        # f32 sums over (B, K) in another order: 1e-6 relative
        np.testing.assert_allclose(float(got[k]), w, rtol=1e-6, atol=0, err_msg=k)


def test_rpn_losses_draws_its_own_sample_from_the_generator(setup):
    s = setup
    b = s["gt"].shape[0]
    args = (torch.from_numpy(np.concatenate([l.reshape(b, -1) for l in s["logits"]], 1)),
            [torch.from_numpy(d) for d in s["deltas"]], torch.from_numpy(s["anchors"]),
            torch.from_numpy(s["gt"]), torch.from_numpy(s["mask"]))
    kw = dict(padding_mask=rpn.dynamic_padding_masks(SHAPES, s["strides"], A,
                                                     torch.from_numpy(s["ori"])),
              max_mesh_dim=32, level_counts=s["counts"], anchors_per_loc=A)
    cfg = rpn.RPNConfig()
    one = rpn.rpn_losses(cfg, torch.Generator().manual_seed(0), *args, **kw)
    two = rpn.rpn_losses(cfg, torch.Generator().manual_seed(0), *args, **kw)
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert all(torch.isfinite(v) for v in one.values())


def test_loss_primitives_match_jax():
    from nerf_rpn_tpu.utils import losses as jl

    rng = np.random.default_rng(2)
    x = rng.normal(0, 3, 1000).astype(np.float32)
    y = rng.normal(0, 3, 1000).astype(np.float32)
    t = (rng.random(1000) < 0.5).astype(np.float32)
    for beta in (1.0 / 9, 1.0, 0.0):
        np.testing.assert_allclose(
            smooth_l1(torch.from_numpy(x), torch.from_numpy(y), beta).numpy(),
            np.asarray(jl.smooth_l1(jnp.asarray(x), jnp.asarray(y), beta)), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        bce_with_logits(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
        np.asarray(jl.bce_with_logits(jnp.asarray(x), jnp.asarray(t))), rtol=1e-6, atol=1e-7)
    pts = rng.uniform(0, 160, (5, 2, 3)).astype(np.float32)
    np.testing.assert_allclose(project_points(torch.from_numpy(pts), 160).numpy(),
                               np.asarray(jax_project(jnp.asarray(pts), 160)), rtol=1e-5)


def test_unported_regression_losses_raise():
    with pytest.raises(NotImplementedError):
        rpn.RPNConfig(reg_loss_type="giou")


def test_sigmoid_focal_loss_matches_jax():
    from nerf_rpn_tpu.utils import losses as jl

    from nerf_rpn_tpu_torch.utils.losses import sigmoid_focal_loss

    rng = np.random.default_rng(4)
    x = rng.normal(0, 3, 1000).astype(np.float32)
    t = (rng.random(1000) < 0.3).astype(np.float32)
    for alpha in (0.25, -1.0):
        np.testing.assert_allclose(
            sigmoid_focal_loss(torch.from_numpy(x), torch.from_numpy(t), alpha).numpy(),
            np.asarray(jl.sigmoid_focal_loss(jnp.asarray(x), jnp.asarray(t), alpha)),
            rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def obb_setup():
    """The OBB form of ``setup``: 8 midpoint-offset deltas an anchor and gt
    OBBs around anchor centres, matched by their enclosing AABBs."""
    rng = np.random.default_rng(6)
    anchors, _, strides, counts = jrpn.build_level_tables(jrpn.RPNConfig(rotated=True),
                                                         MESH, SHAPES)
    anchors = anchors.astype(np.float32)
    b, g = 2, 6
    logits = [rng.normal(0, 1.5, (b, *s, A)).astype(np.float32) for s in SHAPES]
    deltas = [rng.normal(0, 0.2, (b, *s, A * 8)).astype(np.float32) for s in SHAPES]
    centres = anchors[rng.choice(len(anchors), (b, g))]
    gt = np.zeros((b, g, 7), np.float32)
    gt[..., :3] = 0.5 * (centres[..., :3] + centres[..., 3:])
    gt[..., 3:6] = rng.uniform(4, 12, (b, g, 3))
    gt[..., 6] = rng.uniform(-1.4, 1.4, (b, g))
    mask = np.zeros((b, g), bool)
    mask[0, :4] = True
    mask[1, :2] = True
    gt[~mask] = 0.0
    ori = np.array([[32, 30, 32], [30, 32, 28]], np.int32)
    pad = np.asarray(jrpn.dynamic_padding_masks(SHAPES, strides, A, jnp.asarray(ori)))
    matches = []
    for i in range(b):
        hbb = jax_obb2hbb_3d(jnp.asarray(gt[i]))
        iou = jnp.where(pad[i][None], jax_iou(hbb, jnp.asarray(anchors)), -1.0)
        m = jta.match_anchors(iou, jnp.asarray(mask[i]), 0.35, 0.2)
        matches.append(jnp.where(pad[i], m, -2))
    return dict(anchors=anchors, counts=counts, logits=logits, deltas=deltas, gt=gt,
                mask=mask, pad=pad, matches=np.array(jnp.stack(matches)))


@pytest.mark.parametrize("loss_type", ["iou", "giou"])
def test_obb_iou_losses_and_gradients_with_jax_indices(obb_setup, loss_type):
    """``rpn_losses(RPNConfig(rotated=True, reg_loss_type=...))``: the box
    term is the rotated IoU loss of the sampled rows' decoded proposals.
    Loss terms within 1e-5 relative; the gradients with respect to the
    objectness and every level's deltas within 1e-4 of their largest entry
    (f32 sums in another order through the polygon clip)."""
    s = obb_setup
    b = s["gt"].shape[0]
    key = jax.random.PRNGKey(7)
    jcfg = jrpn.RPNConfig(rotated=True, reg_loss_type=loss_type, reg_loss_weight_2d=0.5)
    cfg = rpn.RPNConfig(rotated=True, reg_loss_type=loss_type, reg_loss_weight_2d=0.5)
    obj = np.concatenate([l.reshape(b, -1) for l in s["logits"]], 1)

    def jax_total(o, d):
        out = jrpn.rpn_losses(jcfg, key, o, list(d), jnp.asarray(s["anchors"]),
                              jnp.asarray(s["gt"]), jnp.asarray(s["mask"]),
                              padding_mask=jnp.asarray(s["pad"]), max_mesh_dim=32,
                              level_counts=s["counts"], anchors_per_loc=A)
        return sum(out.values()), out

    (_, want), (g_obj, g_deltas) = jax.value_and_grad(
        jax_total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(obj), [jnp.asarray(d) for d in s["deltas"]])
    indices = [torch.from_numpy(np.array(t)) for t in jta.sample_balanced_indices(
        key, jnp.asarray(s["matches"]), 256, 0.5)]
    assert int(indices[1].sum()) > 0
    t_obj = torch.from_numpy(obj).requires_grad_()
    t_deltas = [torch.from_numpy(d).requires_grad_() for d in s["deltas"]]
    got = rpn.rpn_losses_at(cfg, t_obj, t_deltas, torch.from_numpy(s["anchors"]),
                            torch.from_numpy(s["gt"]), torch.from_numpy(s["matches"]).long(),
                            indices, max_mesh_dim=32, level_counts=s["counts"],
                            anchors_per_loc=A)
    for k, w in want.items():
        assert np.isfinite(float(w)) and float(w) > 0, k
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-5, atol=0, err_msg=k)
    sum(got.values()).backward()
    for t, w in zip([t_obj, *t_deltas], [g_obj, *g_deltas]):
        w = np.asarray(w)
        assert np.isfinite(t.grad.numpy()).all()
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_aabb_iou_loss_is_refused_where_jax_reads_the_aabb_as_an_obb():
    """JAX's ``_rotated_iou_loss`` on 6-column AABBs: column 6 is an empty
    slice and the out-of-range column 4 of the 2D sub-box clamps to column
    3, so it scores ``[x1, y1, x2, y2]`` as a rectangle at (x1, y1) of size
    (x2, y2) turned by y2 radians, not the boxes' IoU.  The port refuses
    the pair instead of training on that value."""
    a = np.array([[0.0, 0.0, 0.0, 2.0, 2.0, 2.0]], np.float32)
    b = np.array([[1.0, 1.0, 1.0, 5.0, 5.0, 5.0]], np.float32)  # AABB IoU 1 / 71
    got = float(jrpn._rotated_iou_loss(jnp.asarray(a), jnp.asarray(b), "linear_iou")[0])
    # what JAX computes: the rectangles (x1, y1, x2, y2, theta = y2) with z
    # extent (z1 - z2 / 2, z1 + z2 / 2) and volume x2 * y2 * z2
    ra = np.array([[0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    rb = np.array([[1.0, 1.0, 1.0, 5.0, 5.0, 5.0, 5.0]], np.float32)
    ious, _, _, _, unions = jri.iou_rotated_3d(jnp.asarray(ra), jnp.asarray(rb), verbose=True)
    want = 1.0 - (float(ious[0] * unions[0]) + 1.0) / (float(unions[0]) + 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert abs(float(ious[0]) - 1.0 / 71.0) > 0.03, float(ious[0])
    with pytest.raises(NotImplementedError, match="rotated_bbox"):
        rpn.RPNConfig(reg_loss_type="linear_iou")


def test_run_rpn_trains_obbs_with_a_rotated_iou_loss(tmp_path):
    """``run_rpn --rotated_bbox --reg_loss_type giou`` trains on the CPU."""
    from nerf_rpn_tpu_torch.cli import run_rpn
    from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_dataset

    data = str(tmp_path)
    write_synthetic_dataset(data, n_train=2, n_val=1, n_test=0, resolution=(32, 32, 32),
                            rotated=True)
    logged = run_rpn.main([
        "--mode", "train", "--rotated_bbox", "--reg_loss_type", "giou",
        "--backbone_type", "swin_t", "--resolution", "32", "--rpn_head_conv_depth", "1",
        "--rpn_pre_nms_top_n_test", "64", "--rpn_post_nms_top_n_test", "32",
        "--device", "cpu", "--num_workers", "0", "--num_epochs", "1", "--log_interval", "1",
        "--features_path", data, "--boxes_path", data, "--dataset_split",
        data + "/split.npz", "--save_path", data + "/run"])
    assert len(logged) == 2
    for m in logged:
        assert np.isfinite(m["loss_rpn_box_reg"]) and m["loss_rpn_box_reg"] > 0, m
        assert np.isfinite(m["grad_norm"]), m
