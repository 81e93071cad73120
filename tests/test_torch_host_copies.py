"""Torch port: its copies of the JAX package's host modules agree with them.

The port keeps its own copies of the numpy host code (anchors, the data
modules, the AABB metrics); this holds each copy to the JAX package's
module on the same inputs: anchor tables and strides bit for bit, the
synthetic dataset writer and the batch iterator array for array (with the
augmentation on), and the AABB Recall / AP report on the same proposals.
"""

import numpy as np
import pytest

from nerf_rpn_tpu.data import datasets as jdatasets
from nerf_rpn_tpu.data import synthetic as jsynthetic
from nerf_rpn_tpu.evaluation import metrics as jmetrics
from nerf_rpn_tpu.models import anchors as janchors
from nerf_rpn_tpu_torch.data import datasets, synthetic
from nerf_rpn_tpu_torch.evaluation import metrics
from nerf_rpn_tpu_torch.models import anchors


@pytest.mark.parametrize("grid,stride", [((16, 16, 10), (4, 4, 4)),
                                         ((7, 5, 3), (32, 32, 32))])
def test_anchor_tables_are_bit_equal(grid, stride):
    for level, sizes in enumerate(anchors.DEFAULT_ANCHOR_SIZES):
        args = (grid, stride, sizes, anchors.DEFAULT_ASPECT_RATIOS)
        np.testing.assert_array_equal(anchors.grid_anchors(*args),
                                      janchors.grid_anchors(*args))
    assert anchors.anchors_per_level(sizes, anchors.DEFAULT_ASPECT_RATIOS) == \
        janchors.anchors_per_level(sizes, janchors.DEFAULT_ASPECT_RATIOS)
    np.testing.assert_array_equal(anchors.padding_valid_mask(grid, stride, (50, 40, 30), 13),
                                  janchors.padding_valid_mask(grid, stride, (50, 40, 30), 13))


def test_level_strides_equal():
    shapes = [(52, 52, 36), (26, 26, 18), (13, 13, 9), (7, 7, 5)]
    assert anchors.level_strides((208, 208, 144), shapes) == \
        janchors.level_strides((208, 208, 144), shapes)


def test_synthetic_writer_and_batch_iterator_give_the_same_arrays(tmp_path):
    split = synthetic.write_synthetic_dataset(str(tmp_path / "port"), n_train=3, n_val=1,
                                              n_test=1, resolution=(24, 20, 16), seed=5,
                                              box_size=(4.0, 8.0))
    jsplit = jsynthetic.write_synthetic_dataset(str(tmp_path / "jax"), n_train=3, n_val=1,
                                                n_test=1, resolution=(24, 20, 16), seed=5,
                                                box_size=(4.0, 8.0))
    assert {k: list(v) for k, v in split.items()} == {k: list(v) for k, v in jsplit.items()}
    for name in split["train_scenes"]:
        for ext in (".npz", ".npy"):
            a = np.load(tmp_path / "port" / f"{name}{ext}")
            b = np.load(tmp_path / "jax" / f"{name}{ext}")
            if ext == ".npz":
                a, b = a["rgbsigma"], b["rgbsigma"]
            np.testing.assert_array_equal(a, b)
    aug = dict(flip_prob=0.5, rotate_prob=0.5, rot_scale_prob=0.5)
    sets = [mod.HypersimRPNDataset(str(tmp_path / d), str(tmp_path / d),
                                   scene_list=list(split["train_scenes"]), **aug)
            for mod, d in ((datasets, "port"), (jdatasets, "jax"))]
    runs = [list(mod.batch_iterator(ds, 2, shuffle=True, seed=3, pad_multiple=16,
                                    max_gt=8, box_dim=6))
            for mod, ds in zip((datasets, jdatasets), sets)]
    assert len(runs[0]) == len(runs[1]) == 2
    for got, want in zip(*runs):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_aabb_recall_and_ap_equal():
    rng = np.random.default_rng(0)
    props, scores, gts = [], [], []
    for n, g in ((200, 5), (120, 3), (0, 2)):
        lo = rng.uniform(0, 40, (n, 3))
        props.append(np.concatenate([lo, lo + rng.uniform(2, 20, (n, 3))], 1).astype(np.float32))
        scores.append(rng.uniform(0, 1, n).astype(np.float32))
        glo = rng.uniform(0, 40, (g, 3))
        gts.append(np.concatenate([glo, glo + rng.uniform(4, 20, (g, 3))], 1).astype(np.float32))
    for limit in (50, 300):
        for th in ([0.25], [0.5], np.arange(0.25, 1.0, 0.05)):
            got = metrics.evaluate_box_proposals_recall(props, scores, gts, thresholds=th,
                                                        limit=limit)
            want = jmetrics.evaluate_box_proposals_recall(props, scores, gts, thresholds=th,
                                                          limit=limit)
            assert got["ar"] == want["ar"] and got["num_pos"] == want["num_pos"]
            np.testing.assert_array_equal(got["gt_overlaps"], want["gt_overlaps"])
    for iou in (0.25, 0.5):
        for top_k in (None, 100):
            got = metrics.evaluate_box_proposals_ap(props, scores, gts, iou, top_k)
            want = jmetrics.evaluate_box_proposals_ap(props, scores, gts, iou, top_k)
            assert got["ap"] == want["ap"]
    # oriented boxes (7-wide): the port's pairwise clip against the JAX
    # metrics' IoU within 1e-5, and the same recall and AP
    obb = [np.concatenate([p[:, :3], p[:, 3:] - p[:, :3],
                           rng.uniform(-np.pi / 2, np.pi / 2, (len(p), 1))], 1).astype(np.float32)
           for p in props]
    obb_gt = [np.concatenate([g[:, :3], g[:, 3:] - g[:, :3],
                              rng.uniform(-np.pi / 2, np.pi / 2, (len(g), 1))], 1).astype(np.float32)
              for g in gts]
    iou = metrics._pairwise_iou_np(obb[0], obb_gt[0])
    np.testing.assert_allclose(iou, jmetrics._pairwise_iou_np(obb[0], obb_gt[0]), rtol=0,
                               atol=1e-5)
    assert (iou > 0).any()
    got = metrics.evaluate_box_proposals_recall(obb, scores, obb_gt, thresholds=[0.1, 0.25])
    want = jmetrics.evaluate_box_proposals_recall(obb, scores, obb_gt, thresholds=[0.1, 0.25])
    assert got["ar"] == want["ar"] and got["num_pos"] == want["num_pos"]
    got = metrics.evaluate_box_proposals_ap(obb, scores, obb_gt, 0.1)
    assert got["ap"] == jmetrics.evaluate_box_proposals_ap(obb, scores, obb_gt, 0.1)["ap"]
