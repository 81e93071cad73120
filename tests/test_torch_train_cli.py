"""Torch port: ``run_rpn --mode train`` on a synthetic 32^3 dataset (CPU).

One epoch over 2 training scenes and 1 validation scene (swin_t,
``conv_depth`` 1): finite losses, ``model_best`` and ``epoch_1`` written
with their sidecars, and ``--mode eval --checkpoint model_best`` giving
the same proposals as the in-memory model.  ``delete_old_checkpoints``
keeps the newest ``--keep_checkpoints`` by mtime.  ``--gpus`` (the
reference's ``0-3`` and ``0,1,2,3`` forms) needs CUDA; ``--wandb`` is
refused.
"""

import json
import os

import numpy as np
import pytest
import torch

from nerf_rpn_tpu.data.synthetic import write_synthetic_dataset
from nerf_rpn_tpu_torch.cli import run_rpn
from nerf_rpn_tpu_torch.parallel import ddp
from nerf_rpn_tpu_torch.train import checkpoint as ckpt_lib


def _argv(data, save, *extra):
    return ["--backbone_type", "swin_t", "--resolution", "32", "--rpn_head_conv_depth", "1",
            "--rpn_pre_nms_top_n_test", "64", "--rpn_post_nms_top_n_test", "32",
            "--device", "cpu", "--num_workers", "0", "--features_path", str(data),
            "--boxes_path", str(data), "--dataset_split", str(data / "split.npz"),
            "--save_path", str(save), "--output_proposals", *extra]


def _proposals(save):
    out = {}
    for name in sorted(os.listdir(save / "proposals")):
        with np.load(save / "proposals" / name) as z:
            out[name] = (z["proposal"], z["score"])
    return out


def test_train_then_eval_from_the_checkpoint(tmp_path):
    data = tmp_path / "data"
    write_synthetic_dataset(str(data), n_train=2, n_val=1, n_test=1, resolution=(32, 32, 32))
    save = tmp_path / "run"
    args = run_rpn.parse_args(["--mode", "train", "--num_epochs", "1", "--batch_size", "1",
                               "--log_interval", "1", *_argv(data, save)])
    trainer = run_rpn.Trainer(args)
    logged = trainer.train_loop()
    assert len(logged) == 2 and trainer.state.step == 2
    for m in logged:
        for k in ("loss", "loss_objectness", "loss_rpn_box_reg", "grad_norm", "param_norm"):
            assert np.isfinite(m[k]) and m[k] > 0, (k, m)
    for name in ("model_best", "epoch_1"):
        assert (save / name).is_file()
        sidecar = json.loads((save / f"{name}.args.json").read_text())
        assert sidecar["backbone_type"] == "swin_t"
    ckpt = torch.load(save / "model_best", weights_only=True)
    assert ckpt["epoch"] == 1 and ckpt["step"] == 2
    assert {"backbone_state_dict", "rpn_head_state_dict", "train_args",
            "optimizer_state_dict", "scheduler_state_dict"} <= set(ckpt)

    # the in-memory model on the test split, then the checkpoint through the CLI
    mem = tmp_path / "mem"
    trainer.args.save_path = str(mem)
    _, _, test_set = run_rpn.common.build_datasets(trainer.args, "eval", augment=False)
    trainer.eval(test_set)
    loaded = tmp_path / "loaded"
    run_rpn.main(["--mode", "eval", "--checkpoint", str(save / "model_best"),
                  *_argv(data, loaded)])
    want, got = _proposals(mem), _proposals(loaded)
    assert want.keys() == got.keys() and want
    for k in want:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(a, b)


def test_load_backbone_only_keeps_the_head(tmp_path):
    data = tmp_path / "data"
    write_synthetic_dataset(str(data), n_train=1, n_val=1, n_test=1, resolution=(32, 32, 32))
    save = tmp_path / "run"
    run_rpn.main(["--mode", "train", "--num_epochs", "1", "--seed", "1", *_argv(data, save)])
    ckpt = torch.load(save / "model_best", weights_only=True)
    args = run_rpn.parse_args(["--mode", "eval", "--checkpoint", str(save / "model_best"),
                               "--load_backbone_only", *_argv(data, tmp_path / "e")])
    trainer = run_rpn.Trainer(args)
    fresh = run_rpn.Trainer(run_rpn.parse_args(["--mode", "eval", *_argv(data, tmp_path / "f")]))
    for k, v in ckpt["backbone_state_dict"].items():
        assert torch.equal(trainer.model.backbone.state_dict()[k], v), k
    for k, v in fresh.model.rpn_head.state_dict().items():
        assert torch.equal(trainer.model.rpn_head.state_dict()[k], v), k


def test_delete_old_checkpoints_keeps_the_newest(tmp_path):
    for i in range(1, 5):
        p = tmp_path / f"epoch_{i}"
        p.write_bytes(b"x")
        (tmp_path / f"epoch_{i}.args.json").write_text("{}")
        os.utime(p, (1000 + i, 1000 + i))
    (tmp_path / "model_best").write_bytes(b"x")
    ckpt_lib.delete_old_checkpoints(str(tmp_path), 2)
    assert sorted(os.listdir(tmp_path)) == [
        "epoch_3", "epoch_3.args.json", "epoch_4", "epoch_4.args.json", "model_best"]
    ckpt_lib.delete_old_checkpoints(str(tmp_path), 0)
    assert sorted(os.listdir(tmp_path)) == ["model_best"]


@pytest.mark.parametrize("flag", [["--gpus", "0,1"], ["--wandb"], ["--reg_loss_type", "giou"]])
def test_unported_train_flags_raise(flag, tmp_path):
    """``--wandb`` and an AABB IoU loss are refused; ``--gpus`` trains on
    CUDA devices, so on this CPU-only machine it raises the missing-CUDA
    error of ``resolve_device`` (and beside ``--device cpu`` a
    ``ValueError``): nothing falls back to the CPU."""
    if flag[0] == "--gpus":
        with pytest.raises(RuntimeError, match="cuda"):
            run_rpn.main(["--mode", "train", "--save_path", str(tmp_path), *flag])
        with pytest.raises(ValueError, match="--device cpu"):
            run_rpn.main(["--mode", "train", "--device", "cpu", "--save_path", str(tmp_path),
                          *flag])
        return
    with pytest.raises(NotImplementedError):
        run_rpn.main(["--mode", "train", "--device", "cpu", "--save_path", str(tmp_path), *flag])


@pytest.mark.parametrize("spec, gpus", [("0-3", [0, 1, 2, 3]), ("0,1,2,3", [0, 1, 2, 3]),
                                        ("0-1,3", [0, 1, 3]), ("2", [2]), ("", [])])
def test_parse_gpus_takes_the_references_forms(spec, gpus):
    assert ddp.parse_gpus(spec) == gpus


@pytest.mark.parametrize("spec", ["a", "0-", "3-1", "0,0", "-1"])
def test_parse_gpus_refuses_malformed_lists(spec):
    with pytest.raises(ValueError, match="--gpus"):
        run_rpn.parse_args(["--gpus", spec])
