"""Torch port: the RCNN second stage's parts (``models/detector.py``, the
rotated coder, the RCNN weight trees and the stage-2 metrics) against the
JAX package on the same inputs.

Inputs are made from a seed with numpy; weights are JAX's, carried across
by ``nerf_rpn_tpu_torch.weights``.  Tolerances: f32 within 1e-5 of a
tensor's largest entry (the coder's angles within 1e-5 absolute); bf16
within 2 bf16 ulps of each row's largest entry (the repo's rule); index
outputs (sampled indices, labels, keep-sets, orders) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rpn_tpu.evaluation import metrics as jmetrics
from nerf_rpn_tpu.models import detector as jdet
from nerf_rpn_tpu.ops import coders as jcoders
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.evaluation import metrics as tmetrics
from nerf_rpn_tpu_torch.models import detector as tdet
from nerf_rpn_tpu_torch.ops import coders as tcoders


def close(got, want, tol=1e-5):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1.0), err


def bf16_close(got, want, ulps=2):
    """Within ``ulps`` bf16 ulps of each row's largest entry."""
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    scale = np.abs(want).max(-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(scale, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulps * ulp), np.abs(got - want).max()


def _obbs(rng, n, near_edge=False):
    ctr = rng.uniform(4, 28, (n, 3))
    size = rng.uniform(2, 10, (n, 3))
    theta = rng.uniform(-np.pi / 2, np.pi / 2, (n, 1))
    if near_edge:
        theta[: n // 2, 0] = np.pi / 2 - rng.uniform(0, 1e-3, n // 2)
        theta[n // 2:, 0] = -np.pi / 2 + rng.uniform(0, 1e-3, n - n // 2)
    return np.concatenate([ctr, size, theta], -1).astype(np.float32)


def _aabbs(rng, n, lo=(0, 24), size=(2, 10)):
    lo = rng.uniform(*lo, (n, 3))
    return np.concatenate([lo, lo + rng.uniform(*size, (n, 3))], -1).astype(np.float32)


# -- the rotated coder --------------------------------------------------------


@pytest.mark.parametrize("near_edge", [False, True], ids=["any_angle", "near_pi_2"])
def test_rotated_coder_matches_jax_and_round_trips(near_edge):
    rng = np.random.default_rng(0)
    rois = _obbs(rng, 256, near_edge)
    gt = rois + np.concatenate([rng.uniform(-1, 1, (256, 3)), rng.uniform(-0.5, 0.5, (256, 3)),
                                rng.uniform(-0.3, 0.3, (256, 1))], -1).astype(np.float32)
    gt[:, 3:6] = np.abs(gt[:, 3:6]) + 0.5
    want = jcoders.encode_rotated(jnp.asarray(gt), jnp.asarray(rois))
    got = tcoders.encode_rotated(torch.from_numpy(gt), torch.from_numpy(rois))
    close(got, want)
    deltas = np.asarray(want)
    dec_j = np.asarray(jcoders.decode_rotated(jnp.asarray(deltas), jnp.asarray(rois)))
    dec_t = tcoders.decode_rotated(torch.from_numpy(deltas), torch.from_numpy(rois)).numpy()
    close(dec_t[:, :6], dec_j[:, :6])
    # the wrap to (-pi/2, pi/2] can send an angle within an ulp of -pi/2 to
    # +pi/2: compare angles modulo pi
    d = np.abs(dec_t[:, 6] - dec_j[:, 6])
    assert np.all(np.minimum(d, np.abs(d - np.pi)) <= 1e-5), d.max()
    assert np.all(dec_t[:, 6] > -np.pi / 2) and np.all(dec_t[:, 6] <= np.pi / 2 + 1e-6)
    # round trip: the decode of the encode is the gt, its angle mod pi
    close(dec_t[:, :6], gt[:, :6])
    d = np.abs(dec_t[:, 6] - gt[:, 6]) % np.pi
    assert np.all(np.minimum(d, np.pi - d) <= 1e-5)


def test_rotated_decode_bf16_deltas_and_clamp():
    rng = np.random.default_rng(1)
    rois = _obbs(rng, 128, near_edge=True)
    deltas = rng.normal(0, 0.5, (128, 7)).astype(np.float32)
    deltas[:8, 3:6] = 12.0          # past BBOX_XFORM_CLIP = log(2000)
    for dt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jcoders.decode_rotated(jnp.asarray(deltas, dt), jnp.asarray(rois))
        got = tcoders.decode_rotated(torch.from_numpy(deltas).to(tdt), torch.from_numpy(rois))
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        close(got[:, :6], np.asarray(want)[:, :6])
        d = np.abs(got[:, 6].numpy() - np.asarray(want)[:, 6])
        assert np.all(np.minimum(d, np.abs(d - np.pi)) <= 1e-5), d.max()
    assert np.allclose(got[:8, 3:6].numpy(), 2000.0 * rois[:8, 3:6], rtol=1e-2)


# -- sampling and labels ------------------------------------------------------


def _scenes(rng, rotated, b=2, r=64):
    if rotated:
        rois = np.stack([_obbs(rng, r) for _ in range(b)])
        gt = np.zeros((b, 4, 7), np.float32)
        gt[:, :2] = rois[:, :2] + rng.uniform(-0.3, 0.3, (b, 2, 7)).astype(np.float32)
    else:
        rois = np.stack([_aabbs(rng, r) for _ in range(b)])
        gt = np.zeros((b, 4, 6), np.float32)
        gt[:, :2] = rois[:, :2] + rng.uniform(-0.3, 0.3, (b, 2, 6)).astype(np.float32)
    # jittered copies of the gt: genuine foreground
    for i in range(b):
        rois[i, 2:10] = np.repeat(gt[i, :2], 4, 0) + rng.uniform(-0.8, 0.8, (8, gt.shape[-1]))
    gt_mask = np.zeros((b, 4), bool)
    gt_mask[:, :2] = True
    valid = np.ones((b, r), bool)
    valid[:, -6:] = False
    levels = rng.integers(0, 4, (b, r)).astype(np.int32)
    return rois, levels, valid, gt, gt_mask


@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
@pytest.mark.parametrize("thresholds", [(0.3, 0.2), (0.9, 0.5), (0.2, 0.0)],
                         ids=["both_pools", "no_fg", "no_bg"])
def test_sample_rois_with_jax_indices(rotated, thresholds):
    rng = np.random.default_rng(2)
    rois, levels, valid, gt, gt_mask = _scenes(rng, rotated)
    kw = dict(rotated=rotated, fg_threshold=thresholds[0], bg_threshold=thresholds[1])
    jcfg, tcfg = jdet.RCNNConfig(**kw), tdet.RCNNConfig(**kw)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    want = jax.vmap(lambda k, r, lv, v, g, gm: jdet.sample_rois(jcfg, k, r, lv, v, g, gm, 24))(
        keys, *map(jnp.asarray, (rois, levels, valid, gt, gt_mask)))
    got = tdet.sample_rois(tcfg, None, *map(torch.from_numpy, (rois, levels, valid, gt, gt_mask)),
                           24, indices=torch.from_numpy(np.asarray(want["indices"])).long())
    for k in ("boxes", "levels", "labels", "matched_gt", "valid", "indices"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
def test_sample_rois_budgets_on_the_ports_draw(rotated):
    """``tests/test_second_stage.py``'s budget properties on the port's own
    draw: at most the fg fraction of the slots, foreground that overlaps
    the gt, every slot valid when both pools are full; all background
    when no RoI reaches the fg threshold; without background, the whole
    foreground pool and no valid slot past it; a scarce background pool
    cycles (sampling with replacement)."""
    rng = np.random.default_rng(4)
    rois, levels, valid, gt, gt_mask = map(torch.from_numpy, _scenes(rng, rotated))
    gen = torch.Generator().manual_seed(0)
    cfg = tdet.RCNNConfig(rotated=rotated, fg_threshold=0.3, bg_threshold=0.2)
    out = tdet.sample_rois(cfg, gen, rois, levels, valid, gt, gt_mask, 32)
    labels = out["labels"].numpy()
    assert out["valid"].all()
    assert np.all((labels.sum(1) > 0) & (labels.sum(1) <= 16))
    max_iou, _ = tdet.match_rois_to_gt(cfg, out["boxes"], out["valid"], gt, gt_mask)
    assert torch.all(max_iou[out["labels"] > 0] >= 0.3)
    assert torch.all(max_iou[out["labels"] == 0] < 0.2)
    assert not np.isin(out["indices"].numpy(), np.arange(58, 64)).any()   # invalid RoIs
    none = tdet.sample_rois(tdet.RCNNConfig(rotated=rotated, fg_threshold=0.99,
                                            bg_threshold=0.5),
                            gen, rois, levels, valid, gt, gt_mask, 16)
    assert none["labels"].sum() == 0 and none["valid"].all()
    all_fg = tdet.sample_rois(tdet.RCNNConfig(rotated=rotated, fg_threshold=0.3,
                                              bg_threshold=0.0),
                              gen, rois, levels, valid, gt, gt_mask, 40)
    n_fg = (max_iou_all := tdet.match_rois_to_gt(cfg, rois, valid, gt, gt_mask)[0]) >= 0.3
    n_fg = (n_fg & valid).sum(1)
    for i in range(2):
        k = int(n_fg[i])
        assert 0 < k < 40
        assert torch.all(all_fg["labels"][i, :k] == 1) and all_fg["valid"][i, :k].all()
        assert not all_fg["valid"][i, k:].any() and all_fg["labels"][i, k:].sum() == 0
        assert len(set(all_fg["indices"][i, :k].tolist())) == k
    assert max_iou_all.shape == (2, 64)
    # 200 slots from 64 RoIs: the background slots cycle through their pool
    many = tdet.sample_rois(cfg, gen, rois, levels, valid, gt, gt_mask, 200)
    assert many["valid"].all()
    bg = many["indices"][0][many["labels"][0] == 0]
    assert len(bg) > len(set(bg.tolist()))


@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
def test_label_all_rois_matches_jax(rotated):
    rng = np.random.default_rng(5)
    rois, _, valid, gt, gt_mask = _scenes(rng, rotated)
    jcfg, tcfg = jdet.RCNNConfig(rotated=rotated), tdet.RCNNConfig(rotated=rotated)
    jl, jm = jax.vmap(lambda r, v, g, gm: jdet.label_all_rois(jcfg, r, v, g, gm))(
        *map(jnp.asarray, (rois, valid, gt, gt_mask)))
    tl, tm = tdet.label_all_rois(tcfg, *map(torch.from_numpy, (rois, valid, gt, gt_mask)))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert 0 < tl.sum() < tl.numel()


# -- the head and the losses --------------------------------------------------


def _head_pair(rng, c, out, rotated, add, flatten, dtype):
    jhead = jdet.RCNNHead(in_channels=c, rotated=rotated, add_conv_layers=add, flatten=flatten,
                          dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    params = jhead.init(jax.random.PRNGKey(0), jnp.zeros((1, *out, c)))["params"]
    params = jax.tree.map(lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(
        np.float32), params)
    thead = tdet.RCNNHead(c, 2, rotated, add, flatten, out, dtype)
    model = tdet.RCNNDetector(thead)
    model.load_state_dict(weights.rcnn_from_jax_params(params), strict=True)
    return jhead, params, model


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
@pytest.mark.parametrize("add,flatten", [(False, True), (True, True), (True, False),
                                         (False, False)],
                         ids=["flatten", "add_flatten", "add_mean", "mean"])
def test_rcnn_head_matches_jax(add, flatten, rotated, dtype):
    """f32: the head's outputs.  bf16: each rounding point on its own (the
    2-ulp rule is per rounding, and an ulp that the tower's convolutions
    round differently moves the Dense outputs by more): each conv on JAX's
    input to it, then the Dense layers on JAX's tower output, compiled with
    ``xla_allow_excess_precision`` off so that XLA keeps the bf16
    roundings."""
    from nerf_rpn_tpu_torch.models.layers import conv3d

    rng = np.random.default_rng(6)
    c, out = 16, (2, 2, 2)
    jhead, params, model = _head_pair(rng, c, out, rotated, add, flatten, dtype)
    x = rng.standard_normal((12, *out, c)).astype(np.float32)
    fn = jax.jit(lambda p, x: jhead.apply({"params": p}, x, capture_intermediates=True))
    (jd, js), state = fn.lower(params, jnp.asarray(x)).compile(
        compiler_options={"xla_allow_excess_precision": False})(params, jnp.asarray(x))
    td, ts = model.head(torch.from_numpy(x))
    assert td.shape == (12, 7 if rotated else 6) and ts.shape == (12, 2)
    assert td.dtype == dtype and ts.dtype == dtype
    if dtype == torch.float32:
        close(td, jd)
        close(ts, js)
        return
    head = model.head
    if add:
        inter = state["intermediates"]
        inp = torch.from_numpy(x)
        for name in ("conv_0", "conv_1"):
            want = np.asarray(inter[name]["__call__"][0].astype(jnp.float32))
            got = conv3d(inp, getattr(head, name), dtype)
            bf16_close(got, want)
            inp = torch.relu(torch.from_numpy(want).to(dtype))
        head.add_conv_layers = False
        td, ts = head(inp)
    bf16_close(td, jd)
    bf16_close(ts, js)


@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
def test_rcnn_losses_match_jax(rotated):
    rng = np.random.default_rng(7)
    n = 48
    if rotated:
        rois = _obbs(rng, n)
        gt = rois + rng.uniform(-0.5, 0.5, (n, 7)).astype(np.float32)
    else:
        rois = _aabbs(rng, n)
        gt = rois + rng.uniform(-0.5, 0.5, (n, 6)).astype(np.float32)
    labels = (rng.uniform(size=n) > 0.6).astype(np.float32)
    gt[labels == 0] = 0.0           # non-fg rows: a zero gt would encode log(0)
    valid = rng.uniform(size=n) > 0.1
    deltas = rng.normal(0, 0.3, (n, gt.shape[1])).astype(np.float32)
    scores = rng.normal(0, 2, (n, 2)).astype(np.float32)
    jcfg, tcfg = jdet.RCNNConfig(rotated=rotated), tdet.RCNNConfig(rotated=rotated)
    want = jdet.rcnn_losses(jcfg, *map(jnp.asarray, (deltas, scores, labels, gt, rois, valid)))
    got = tdet.rcnn_losses(tcfg, *map(torch.from_numpy, (deltas, scores, labels, gt, rois, valid)))
    for k in want:
        assert np.isfinite(float(got[k]))
        close(got[k], want[k])
    none = tdet.rcnn_losses(tcfg, *map(torch.from_numpy, (deltas, scores, 0 * labels, gt, rois,
                                                         valid)))
    assert float(none["loss_rpn_box_reg"]) == 0.0


# -- the filter ---------------------------------------------------------------


@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
def test_filter_refined_proposals_matches_jax_with_ties(rotated):
    rng = np.random.default_rng(8)
    n = 96
    if rotated:
        boxes = _obbs(rng, n)
        boxes[:6, 0] = -1.0                          # centres off the grid
    else:
        boxes = _aabbs(rng, n, lo=(-4, 28))          # some cross the grid's edge
    boxes[40:48] = boxes[32:40] + 0.1                # heavy overlaps
    boxes[50, 3:6] = boxes[50, 0:3] + 1e-4 if not rotated else 1e-4   # too small
    fg = np.round(rng.uniform(0, 1, n), 1).astype(np.float32)   # ties
    probs = np.stack([1 - fg, fg], -1).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    mesh = np.array([32.0, 32.0, 28.0], np.float32)
    jcfg, tcfg = jdet.RCNNConfig(rotated=rotated), tdet.RCNNConfig(rotated=rotated)
    for score_t, nms_t, num_t in ((0.5, 0.1, 300), (0.3, 0.3, 7)):
        jb, jk, jo = jdet.filter_refined_proposals(
            jcfg, jnp.asarray(boxes), jnp.asarray(probs), jnp.asarray(valid), jnp.asarray(mesh),
            score_t, nms_t, num_t)
        tb, tk, to = tdet.filter_refined_proposals(
            tcfg, torch.from_numpy(boxes), torch.from_numpy(probs), torch.from_numpy(valid),
            torch.from_numpy(mesh), score_t, nms_t, num_t)
        close(tb, jb)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert 0 < tk.sum() <= num_t


# -- the weight trees ---------------------------------------------------------


def test_rcnn_weight_trees_round_trip():
    from nerf_rpn_tpu.models.nerf_rpn import build_backbone as jbuild
    from nerf_rpn_tpu_torch.models.nerf_rpn import build_backbone

    rng = np.random.default_rng(9)
    _, head_params, model = _head_pair(rng, 32, (2, 2, 2), True, True, True, torch.float32)
    back = weights.rcnn_to_jax_variables(model.state_dict())
    assert back["batch_stats"] == {}
    for k, v in weights.flatten_tree(head_params).items():
        np.testing.assert_array_equal(weights.flatten_tree(back["params"])[k], v)
    # fine-tune: {"backbone", "head"} and the backbone's own batch_stats
    bvars = jbuild("resnet_tiny", 32).init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 32, 4)))
    stats = jax.tree.map(lambda s: np.asarray(s) + 0.25, bvars["batch_stats"])
    params = {"backbone": jax.tree.map(np.asarray, bvars["params"]), "head": head_params}
    ft = tdet.RCNNDetector(tdet.RCNNHead(32, 2, True, True, True, (2, 2, 2)),
                           build_backbone("resnet_tiny", 32))
    ft.load_state_dict(weights.rcnn_from_jax_params(params, stats, ft.backbone), strict=True)
    back = weights.rcnn_to_jax_variables(ft.state_dict(), ft.backbone)
    for tree, ref in ((back["params"], params), (back["batch_stats"], stats)):
        flat, want = weights.flatten_tree(tree), weights.flatten_tree(ref)
        assert set(flat) == set(want)
        for k in want:
            np.testing.assert_array_equal(flat[k], want[k])


# -- the stage-2 metrics ------------------------------------------------------


def test_stage2_metrics_match_jax():
    rng = np.random.default_rng(10)
    props = [_aabbs(rng, n) for n in (30, 0, 12)]
    scores = [rng.uniform(size=len(p)).astype(np.float32) for p in props]
    gts = [_aabbs(rng, 3), _aabbs(rng, 2), _aabbs(rng, 4)]
    props[0][:3] = gts[0] + 0.2
    labels = [(rng.uniform(size=len(p)) > 0.5).astype(np.int32) for p in props]
    for name, args in (
            ("evaluate_classification", (scores, labels, 0.5)),
            ("evaluate_box_proposals_precision", (props, scores, gts)),
            ("evaluate_box_proposals_average_precision", (props, scores, gts, 0.25)),
            ("evaluate_box_proposals_average_precision", (props, scores, gts, 0.1, 5))):
        want, got = getattr(jmetrics, name)(*args), getattr(tmetrics, name)(*args)
        assert set(got) == set(want), name
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    nonempty = [p for p in props if len(p)], [g for p, g in zip(props, gts) if len(p)]
    for w, g in zip(jmetrics.evaluate_labels(*nonempty), tmetrics.evaluate_labels(*nonempty)):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a, b)
