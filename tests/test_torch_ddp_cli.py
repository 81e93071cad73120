"""The drivers' ``--mode train --device cpu`` on two ranks started with
torchrun's environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``): gloo, ``resnet_tiny`` at 32^3, a global
batch of 2 (a scene a rank), two epochs of ``run_rpn``, ``run_fcos`` and
``run_rpn_detect --fine_tune`` (one of its scenes cropped, so that a
rank's batch is padded to the other's grid).

Each rank gets its own ``--save_path``, so the files show who wrote them:
rank 0 alone writes ``model_best``, ``epoch_N`` and the log file.  Both
ranks exit 0, log the same global loss terms (rank 1 with its rank in
front), and end with bit-equal weights (each rank's model is saved by a
wrapper around ``Trainer.train_loop``).  ``--batch_size 3`` does not
divide over 2 ranks: both ranks raise.  ``run_rpn_detect``'s
``pad_to_global`` pads each rank's grids (or levels) to the largest over
the ranks, with zeros.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from nerf_rpn_tpu_torch.cli.run_rpn_detect import Trainer as DetectTrainer
from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_dataset, write_synthetic_rois
from nerf_rpn_tpu_torch.parallel import ddp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib
import sys
import torch

torch.set_num_threads(2)
from nerf_rpn_tpu_torch.parallel import ddp

cli = importlib.import_module("nerf_rpn_tpu_torch.cli." + sys.argv[2])
train_loop = cli.Trainer.train_loop


def keep_weights(self):
    logged = train_loop(self)
    torch.save(self.model.state_dict(), f"{sys.argv[1]}/rank{ddp.rank()}.pt")
    return logged


cli.Trainer.train_loop = keep_weights
cli.main(sys.argv[3:])
"""

COMMON = ["--backbone_type", "resnet_tiny", "--resolution", "32", "--num_workers", "0"]
DRIVERS = {
    "run_rpn": ["--rpn_head_conv_depth", "1"],
    "run_fcos": ["--num_convs", "1"],
    "run_rpn_detect": ["--fine_tune", "--remap", "--feature_input_dim", "32",
                       "--output_size", "2", "2", "2", "--is_flatten", "--max_rois", "20",
                       "--cls_batch_size", "32"],
}


def _two_ranks(tmp_path, data, driver, *extra):
    """Starts both ranks, each with its own save path; returns (exit code,
    stdout, stderr) a rank."""
    port = ddp.free_port()
    paths = ["--features_path", str(data), "--boxes_path", str(data),
             "--dataset_split", str(data / "split.npz")]
    if driver == "run_rpn_detect":
        paths += ["--rois_path", str(data / "rois")]
    procs = []
    for r in (0, 1):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                   PYTHONPATH=REPO)
        argv = ["--mode", "train", "--device", "cpu", *COMMON, *DRIVERS[driver], *paths,
                "--save_path", str(tmp_path / f"save{r}"), "--log_to_file",
                "--log_interval", "1", *extra]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", SCRIPT, str(tmp_path), driver, *argv], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            out.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            p.kill()
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("ddp_cli_data")
    write_synthetic_dataset(str(d), n_train=4, n_val=1, n_test=1, resolution=(32, 32, 32))
    write_synthetic_rois(str(d), str(d / "rois"))
    # one train scene of 24 x 32 x 32: run_rpn_detect pads a batch to its
    # largest scene, so at world 2 a rank pads to the other rank's grid
    name = str(np.load(d / "split.npz")["train_scenes"][0])
    with np.load(d / f"{name}.npz") as z:
        grids = dict(z)
    grids["rgbsigma"] = grids["rgbsigma"][:24]
    np.savez(d / f"{name}.npz", **grids)
    return d


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_two_ranks_train_alike_and_rank0_alone_writes(data, tmp_path, driver):
    (rc0, out0, err0), (rc1, out1, err1) = _two_ranks(tmp_path, data, driver,
                                                      "--batch_size", "2", "--num_epochs", "2")
    assert rc0 == 0 and rc1 == 0, (err0[-2000:], err1[-2000:])
    log = f"{driver}_torch.log"
    # (the RCNN driver's validation eval writes its report too)
    assert sorted(os.listdir(tmp_path / "save0")) == sorted(
        ["epoch_2", "epoch_2.args.json", "model_best", "model_best.args.json", log,
         *(["eval.json"] if driver == "run_rpn_detect" else [])])
    assert os.listdir(tmp_path / "save1") == []
    text = (tmp_path / "save0" / log).read_text()
    assert "Epoch 2 [1]" in text and "[rank" not in text
    # 4 scenes, a global batch of 2: 2 steps an epoch, the same global
    # loss terms on both ranks
    steps = [re.findall(r"Epoch \d \[\d\] (loss .*) \(", out) for out in (out0, out1)]
    assert len(steps[0]) == 4 and steps[0] == steps[1]
    assert all(m.split(" INFO ")[1].startswith("[rank 1]")
               for m in out1.splitlines() if " INFO " in m)
    w0, w1 = (torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in (0, 1))
    assert set(w0) == set(w1)
    for k, v in w0.items():
        assert torch.equal(v, w1[k]), k
    # the BatchNorms moved once a step on both ranks
    assert int(w0["backbone.bn1.num_batches_tracked"]) == 4


def test_a_batch_that_does_not_divide_over_the_ranks_raises(data, tmp_path):
    for rc, _, err in _two_ranks(tmp_path, data, "run_rpn", "--batch_size", "3",
                                 "--num_epochs", "1"):
        assert rc != 0 and "must be divisible by the number of ranks (2)" in err, err[-2000:]


def _pad_rank(work):
    r = ddp.rank()
    grids = np.ones((1, 24 + 8 * r, 32 - 8 * r, 16, 4), np.float32)
    levels = [np.ones((1, 8 - 2 * r, 8, 4 + 4 * r, 3), np.float32),
              np.ones((1, 2, 2 + r, 2, 3), np.float32)]
    out = (DetectTrainer.pad_to_global({"grids": grids, "rois": r}),
           DetectTrainer.pad_to_global({"features": levels, "rois": r}))
    torch.save(out, f"{work}/pad{r}.pt")


def test_rcnn_batches_are_padded_to_the_largest_over_the_ranks(tmp_path):
    cpu = torch.device("cpu")
    ddp.launch(_pad_rank, (str(tmp_path),), [cpu, cpu], "gloo",
               init_method=f"file://{tmp_path}/rendezvous")
    for r in (0, 1):
        fine, feats = torch.load(tmp_path / f"pad{r}.pt", weights_only=False)
        assert fine["rois"] == r and feats["rois"] == r
        assert fine["grids"].shape == (1, 32, 32, 16, 4)
        assert [f.shape for f in feats["features"]] == [(1, 8, 8, 8, 3), (1, 2, 3, 2, 3)]
        # the rank's own voxels, then zeros
        assert fine["grids"].sum() == (24 + 8 * r) * (32 - 8 * r) * 16 * 4
        assert feats["features"][0].sum() == (8 - 2 * r) * 8 * (4 + 4 * r) * 3
