"""Torch port: the stage-1 -> stage-2 bridge and the RCNN driver
(``nerf_rpn_tpu_torch/cli/run_rpn_detect.py``) on the CPU.

- ``run_rpn --save_results`` files (``resnet_tiny``, 32^3) load through the
  port's ``RPNClassificationDataset`` in the features mode and drive the
  port's RCNN eval step; ``run_fcos --output_proposals --save_level_index``
  files hold the RoIs and their levels under ``proposal`` /
  ``level_indices``: the JAX package's dataset reads ``proposals`` and
  raises ``KeyError`` on them, the port's reads either key, and such files
  train ``run_rpn_detect --fine_tune`` for an epoch;
- ``run_rpn_detect --device cpu --mode train --fine_tune`` on synthetic
  32^3 scenes and their generated RoIs, then ``--mode eval --checkpoint
  model_best --output_proposals``, writes ``eval.json`` with the JAX
  driver's keys and the proposals npz; the features mode trains and
  evaluates on ``run_rpn --save_results`` files;
- the batches keep the JAX driver's order, drop and padding;
- ``--pretrained`` loads the backbone of a stage-1 checkpoint exactly and
  raises on a file that does not load (the JAX driver warns and goes on),
  and is refused without ``--fine_tune``; ``--wandb`` is refused;
  without a GPU the default device and ``--gpus`` raise.
"""

import json
import os

import numpy as np
import pytest
import torch

from nerf_rpn_tpu_torch.cli import run_fcos, run_rpn, run_rpn_detect
from nerf_rpn_tpu_torch.data.datasets import (RPNClassificationDataset,
                                               collate_classification_batch)
from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_dataset, write_synthetic_rois

# eval.json of the JAX driver (nerf_rpn_tpu/cli/run_rpn_detect.py:404-418):
# the AP dicts of evaluate_box_proposals_ap and the classification metrics
EVAL_JSON_KEYS = {
    "ap_25": {"ap", "precisions", "recalls", "thresholds", "num_det"},
    "ap_50": {"ap", "precisions", "recalls", "thresholds", "num_det"},
    "classification": {"precision", "accuracy", "precision_100"},
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rcnn_cli"))
    write_synthetic_dataset(d, n_train=2, n_val=1, n_test=1, resolution=(32, 32, 32))
    write_synthetic_rois(d, os.path.join(d, "rois"))
    return d


def _stage1_args(d):
    return ["--backbone_type", "resnet_tiny", "--resolution", "32", "--device", "cpu",
            "--num_workers", "0", "--features_path", d, "--boxes_path", d,
            "--dataset_split", os.path.join(d, "split.npz")]


@pytest.fixture(scope="module")
def stage1(data):
    """A one-epoch ``run_rpn`` checkpoint and its ``--save_results`` files."""
    common = [*_stage1_args(data), "--rpn_head_conv_depth", "1",
              "--rpn_pre_nms_top_n_test", "64", "--rpn_post_nms_top_n_test", "32"]
    run_rpn.main(["--mode", "train", "--num_epochs", "1", "--batch_size", "2",
                  "--save_path", os.path.join(data, "rpn"), *common])
    run_rpn.main(["--mode", "eval", "--checkpoint", os.path.join(data, "rpn", "model_best"),
                  "--save_path", os.path.join(data, "rpn_out"), "--save_results",
                  "--output_all", *common])
    return os.path.join(data, "rpn", "model_best"), os.path.join(data, "rpn_out", "results")


def _detect_args(data, rois, save, *extra):
    return ["--features_path", data, "--boxes_path", data, "--rois_path", rois,
            "--dataset_split", os.path.join(data, "split.npz"), "--save_path", save,
            "--device", "cpu", "--num_workers", "0", "--feature_input_dim", "32",
            "--output_size", "2", "2", "2", "--is_flatten", "--max_rois", "24",
            "--cls_batch_size", "16", "--batch_size", "2", "--nms_thresh", "0.3",
            "--filter_num_threhold", "20", *extra]


def test_save_results_and_fcos_proposals_feed_the_dataset(data, stage1):
    from nerf_rpn_tpu.data.datasets import RPNClassificationDataset as JaxDataset
    from nerf_rpn_tpu_torch.models.detector import RCNNConfig, RCNNDetector, RCNNHead
    from nerf_rpn_tpu_torch.train.steps import make_rcnn_eval_step

    _, results = stage1
    scenes = ["synth000", "synth001", "synth002", "synth003"]
    ds = RPNClassificationDataset(os.path.join(results, "features"), data,
                                  os.path.join(results, "proposals"), scene_names=scenes)
    assert ds.scene_names == scenes
    feats, boxes, props, levels, _ = ds[3]
    assert [f.shape for f in feats] == [(8, 8, 8, 32), (4, 4, 4, 32), (2, 2, 2, 32),
                                        (1, 1, 1, 32)]
    assert props.shape[1] == 6 and len(levels) == len(props) > 0
    batch = collate_classification_batch([ds[0], ds[3]], max_rois=32, max_gt=4)
    model = RCNNDetector(RCNNHead(32, output_size=(2, 2, 2)))
    out = make_rcnn_eval_step(model, RCNNConfig(output_size=(2, 2, 2)), (4, 8, 16, 32))(
        {k: [torch.from_numpy(f) for f in v] if k == "features" else torch.from_numpy(v)
         for k, v in batch.items() if k != "names"})
    assert torch.isfinite(out["scores"]).all() and out["scores"].shape == (2, 32, 2)

    fcos = os.path.join(data, "fcos_out")
    run_fcos.main(["--mode", "eval", "--num_convs", "1", "--pre_nms_top_n", "64",
                   "--fpn_post_nms_top_n", "32", "--output_proposals", "--save_level_index",
                   "--output_all", "--save_path", fcos, *_stage1_args(data)])
    props_dir = os.path.join(fcos, "proposals")
    with np.load(os.path.join(props_dir, "synth000.npz")) as z:
        assert sorted(z.files) == ["level_indices", "proposal", "score"]
    # the JAX package's dataset reads ``proposals`` only (a deliberate
    # divergence, ROADMAP.md)
    with pytest.raises(KeyError, match="proposals"):
        JaxDataset(data, data, props_dir, scene_names=scenes, fine_tune=True)
    ds = RPNClassificationDataset(data, data, props_dir, scene_names=scenes, fine_tune=True)
    grid, _, props, levels, _ = ds[1]
    assert grid.shape == (32, 32, 32, 4) and len(levels) == len(props) > 0
    with np.load(os.path.join(props_dir, "synth001.npz")) as z:
        keep = np.prod(z["proposal"][:, 3:6], axis=1) / 32 ** 3 <= 0.5
        np.testing.assert_array_equal(props, z["proposal"][keep])
        np.testing.assert_array_equal(levels, z["level_indices"][keep])
    batch = collate_classification_batch([ds[0], ds[1]], max_rois=32, max_gt=4)
    assert batch["grids"].shape == (2, 32, 32, 32, 4) and batch["roi_valid"].any()
    # and they train the fine-tune mode for an epoch
    save = os.path.join(data, "rcnn_from_fcos")
    logged = run_rpn_detect.main(["--mode", "train", "--num_epochs", "1", *_detect_args(
        data, props_dir, save, "--fine_tune", "--remap", "--backbone_type", "resnet_tiny",
        "--resolution", "32")])
    assert len(logged) == 1 and np.isfinite(logged[0]["loss"]) and logged[0]["loss"] > 0
    assert os.path.isfile(os.path.join(save, "model_best"))


def test_fine_tune_train_then_eval_from_the_checkpoint(data, stage1):
    pretrained, _ = stage1
    save = os.path.join(data, "rcnn")
    common = _detect_args(data, os.path.join(data, "rois"), save, "--fine_tune", "--remap",
                          "--backbone_type", "resnet_tiny", "--resolution", "32")
    logged = run_rpn_detect.main(["--mode", "train", "--num_epochs", "1", "--log_interval", "1",
                                  "--pretrained", pretrained, "--log_to_file", *common])
    assert len(logged) == 1 and np.isfinite(logged[0]["loss"]) and logged[0]["loss"] > 0
    assert logged[0]["fg_rois"] + logged[0]["bg_rois"] == 16
    for name in ("model_best", "epoch_1", "model_best.args.json", "run_rpn_detect_torch.log"):
        assert os.path.isfile(os.path.join(save, name)), name
    ckpt = torch.load(os.path.join(save, "model_best"), weights_only=True)
    assert set(ckpt["rcnn_state_dict"]) == {"bbox_pred.weight", "bbox_pred.bias",
                                             "cls_score.weight", "cls_score.bias"}
    # the stage-1 step and this one
    assert int(ckpt["backbone_state_dict"]["bn1.num_batches_tracked"]) == 2
    out = os.path.join(data, "rcnn_eval")
    res = run_rpn_detect.main([
        "--mode", "eval", "--checkpoint", os.path.join(save, "model_best"), "--output_proposals",
        *_detect_args(data, os.path.join(data, "rois"), out, "--fine_tune", "--remap",
                      "--backbone_type", "resnet_tiny", "--resolution", "32")])
    with open(os.path.join(out, "eval.json")) as f:
        report = json.load(f)
    assert {k: set(v) for k, v in report.items()} == EVAL_JSON_KEYS
    assert report["classification"] == res["classification"]
    assert 0.0 <= report["classification"]["accuracy"] <= 1.0
    with np.load(os.path.join(out, "proposals", "synth003.npz")) as z:
        assert z["proposal"].shape[1] == 6 and len(z["score"]) == len(z["proposal"])


def test_features_mode_on_save_results(data, stage1):
    _, results = stage1
    save = os.path.join(data, "rcnn_features")
    common = _detect_args(os.path.join(results, "features"), os.path.join(results, "proposals"),
                          save, "--is_add_layer")
    common[common.index("--boxes_path") + 1] = data
    common[common.index("--dataset_split") + 1] = os.path.join(data, "split.npz")
    logged = run_rpn_detect.main(["--mode", "train", "--num_epochs", "1", "--log_interval", "1",
                                  *common])
    assert len(logged) == 1 and np.isfinite(logged[0]["loss"])
    res = run_rpn_detect.main(["--mode", "eval", "--checkpoint",
                               os.path.join(save, "model_best"), *common])
    assert {k: set(v) for k, v in res.items()} == EVAL_JSON_KEYS


def test_pretrained_loads_the_stage1_backbone_exactly(data, stage1):
    pretrained, _ = stage1
    args = run_rpn_detect.parse_args(_detect_args(
        data, os.path.join(data, "rois"), os.path.join(data, "x"), "--fine_tune",
        "--backbone_type", "resnet_tiny", "--resolution", "32", "--pretrained", pretrained))
    trainer = run_rpn_detect.Trainer(args)
    want = torch.load(pretrained, weights_only=True)["backbone_state_dict"]
    got = trainer.model.backbone.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_refusals_and_a_pretrained_file_that_does_not_load(data, stage1, tmp_path):
    base = _detect_args(data, os.path.join(data, "rois"), str(tmp_path))
    with pytest.raises(NotImplementedError, match="wandb"):
        run_rpn_detect.parse_args([*base, "--wandb"])
    # --gpus names CUDA devices: missing here, and never beside --device cpu
    with pytest.raises(RuntimeError, match="cuda"):
        run_rpn_detect.main([*base, "--device", "cuda", "--gpus", "0,1"])
    with pytest.raises(ValueError, match="--device cpu"):
        run_rpn_detect.main([*base, "--gpus", "0-3"])
    with pytest.raises(ValueError, match="--fine_tune"):
        run_rpn_detect.parse_args([*base, "--pretrained", "x"])
    assert run_rpn_detect.parse_args([*base, "--use_cuda"]).use_cuda
    # no file, and a stage-1 file of another backbone (resnet_tiny's for a
    # resnet): the JAX driver logs a warning and trains on a random
    # backbone; the port raises
    pretrained, _ = stage1
    ft = [*base, "--fine_tune", "--backbone_type", "resnet", "--resolution", "32"]
    with pytest.raises(FileNotFoundError):
        run_rpn_detect.Trainer(run_rpn_detect.parse_args(
            [*ft, "--pretrained", str(tmp_path / "missing")]))
    with pytest.raises(RuntimeError, match="state_dict"):
        run_rpn_detect.Trainer(run_rpn_detect.parse_args([*ft, "--pretrained", pretrained]))


def test_default_device_raises_without_a_gpu(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    args = _detect_args(data, os.path.join(data, "rois"), str(tmp_path))
    args = args[:args.index("--device")] + args[args.index("--device") + 2:]
    assert run_rpn_detect.parse_args(args).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        run_rpn_detect.main(["--mode", "eval", *args])


@pytest.mark.parametrize("workers", [0, 2])
def test_batches_keep_the_jax_drivers_order(workers):
    """``Trainer.batches`` against the JAX driver's ``_batches``
    (``nerf_rpn_tpu/cli/run_rpn_detect.py:242-291``) on one process: the
    train order is ``default_rng(seed)``'s shuffle with the ragged batch
    dropped; eval keeps the order and pads the last batch with its last
    scene, and each batch comes with its number of real scenes."""
    from types import SimpleNamespace

    n, bs, seed = 7, 3, 4
    trainer = SimpleNamespace(
        args=SimpleNamespace(batch_size=bs, num_workers=workers, prefetch_batches=2),
        _collate=list)
    scenes = list(range(n))
    order = np.arange(n)
    np.random.default_rng(seed).shuffle(order)
    train = list(run_rpn_detect.Trainer.batches(trainer, scenes, True, seed=seed))
    assert train == [(list(order[:3]), 3), (list(order[3:6]), 3)]
    assert list(run_rpn_detect.Trainer.batches(trainer, scenes)) == [
        ([0, 1, 2], 3), ([3, 4, 5], 3), ([6, 6, 6], 1)]
