"""Scene-parallel eval (``parallel/ddp.py``: ``eval_blocks``,
``gather_scenes``; the JAX drivers' eval mesh) on two CPU ranks started
with torchrun's environment (gloo), ``resnet_tiny`` at 32^3, random weights
from ``--seed``.

- ``--mode eval --batch_size 2`` on 3 test scenes for ``run_rpn`` (AABB,
  ``--save_results --output_voxel_scores --output_proposals``), ``run_fcos``
  (``--save_level_index --output_voxel_scores --output_proposals``) and
  ``run_rpn_detect --fine_tune`` (``--output_proposals``): rank 0 writes
  ``eval.json`` and the proposals, each rank the per-scene files of the
  scenes it evaluated, and every file equals, byte for byte, the one of one
  process that evaluates the same batches (``--batch_size 1``: on the CPU
  a convolution over two scenes rounds otherwise than over one, so the one
  process at the whole batch of 2 is not bit-equal to either);
- the ragged last batch (1 scene) goes to rank 0 alone, the JAX re-mesh;
- a ``--gpus``-style training run enters the validation eval on both
  ranks, each with its share of the validation scenes.
"""

import os
import subprocess
import sys

import pytest
import torch

from nerf_rpn_tpu_torch.cli import run_fcos, run_rpn, run_rpn_detect
from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_dataset, write_synthetic_rois
from nerf_rpn_tpu_torch.parallel import ddp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each rank runs the jobs in turn, each in a group of its own (a port a job);
# Trainer.eval records the scenes that the rank evaluated
SCRIPT = r"""
import importlib, json, os, sys
import torch

torch.set_num_threads(2)
work, ports, jobs = sys.argv[1], sys.argv[2].split(","), json.loads(sys.argv[3])
unwrapped = {}
for port, (driver, argv) in zip(ports, jobs):
    cli = importlib.import_module("nerf_rpn_tpu_torch.cli." + driver)
    evaluate = unwrapped.setdefault(driver, cli.Trainer.eval)

    def eval_and_record(self, dataset, *a, _evaluate=evaluate, _argv=argv, **kw):
        from nerf_rpn_tpu_torch.parallel import ddp
        names = [dataset.scene_names[int(i)] for idx, _ in ddp.eval_blocks(
            len(dataset), self.args.batch_size, pad_last=hasattr(self, "pad_to_global"))
            for i in idx]
        save = _argv[_argv.index("--save_path") + 1]
        with open(os.path.join(work, f"evaluated_rank{ddp.rank()}"), "a") as f:
            f.write(json.dumps([os.path.basename(save), names]) + "\n")
        return _evaluate(self, dataset, *a, **kw)

    cli.Trainer.eval = eval_and_record
    os.environ["MASTER_PORT"] = port
    cli.main(argv)
"""

BASE = ["--device", "cpu", "--num_workers", "0", "--backbone_type", "resnet_tiny",
        "--resolution", "32"]
RPN = ["--rpn_head_conv_depth", "1", "--rpn_pre_nms_top_n_test", "64",
       "--rpn_post_nms_top_n_test", "32"]
EVALS = {
    "run_rpn": [*RPN, "--save_results", "--output_voxel_scores", "--output_proposals"],
    "run_fcos": ["--num_convs", "1", "--pre_nms_top_n", "64", "--fpn_post_nms_top_n", "32",
                 "--save_level_index", "--output_voxel_scores", "--output_proposals"],
    "run_rpn_detect": ["--fine_tune", "--remap", "--feature_input_dim", "32", "--output_size",
                       "2", "2", "2", "--is_flatten", "--max_rois", "24",
                       "--output_proposals"],
}


def _paths(data, driver):
    out = ["--features_path", str(data), "--boxes_path", str(data),
           "--dataset_split", str(data / "split.npz")]
    return out + (["--rois_path", str(data / "rois")] if driver == "run_rpn_detect" else [])


def _files(root):
    """{relative path: bytes} of every file under ``root`` (logs aside)."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if not n.endswith(".log"):
                with open(os.path.join(d, n), "rb") as f:
                    out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_ranks_data")
    write_synthetic_dataset(str(d), n_train=2, n_val=3, n_test=3, resolution=(32, 32, 32))
    write_synthetic_rois(str(d), str(d / "rois"))
    return d


@pytest.fixture(scope="module")
def two_ranks(data, tmp_path_factory):
    """Both ranks run the three evals, then a one-epoch ``run_rpn`` train
    run, each rank with its own save paths; returns (work dir, records of
    the scenes each rank evaluated)."""
    import json

    work = tmp_path_factory.mktemp("eval_ranks")
    jobs = {r: [] for r in (0, 1)}
    for r in (0, 1):
        for driver, flags in EVALS.items():
            jobs[r].append((driver, ["--mode", "eval", "--batch_size", "2", *BASE, *flags,
                                     *_paths(data, driver),
                                     "--save_path", str(work / f"{driver}_rank{r}")]))
        jobs[r].append(("run_rpn", ["--mode", "train", "--batch_size", "2",
                                    "--num_epochs", "1", *BASE, *RPN,
                                    *_paths(data, "run_rpn"),
                                    "--save_path", str(work / f"train_rank{r}")]))
    ports = ",".join(str(ddp.free_port()) for _ in jobs[0])
    procs = []
    for r in (0, 1):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", OMP_NUM_THREADS="2", PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", SCRIPT, str(work), ports, json.dumps(jobs[r])], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    records = {}
    for r in (0, 1):
        with open(work / f"evaluated_rank{r}") as f:
            records[r] = [json.loads(line) for line in f]
    return work, records


@pytest.mark.parametrize("driver", list(EVALS))
def test_two_ranks_write_what_one_process_writes(data, two_ranks, tmp_path, driver):
    work, _ = two_ranks
    cli = {"run_rpn": run_rpn, "run_fcos": run_fcos, "run_rpn_detect": run_rpn_detect}[driver]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the ranks' count: CPU kernels split work by it
    try:
        cli.main(["--mode", "eval", "--batch_size", "1", *BASE, *EVALS[driver],
                  *_paths(data, driver), "--save_path", str(tmp_path / "one")])
    finally:
        torch.set_num_threads(threads)
    want = _files(tmp_path / "one")
    rank0, rank1 = _files(work / f"{driver}_rank0"), _files(work / f"{driver}_rank1")
    scenes = ["synth005.npz", "synth006.npz", "synth007.npz"]
    # rank 0: the report, every scene's proposals, the per-scene files of
    # scenes 0 and 2; rank 1: those of scene 1
    per_scene = {"run_rpn": ["voxel_scores", "results/features", "results/proposals"],
                 "run_fcos": ["voxel_scores"], "run_rpn_detect": []}[driver]
    assert sorted(rank0) == sorted(
        ["eval.json", *(f"proposals/{s}" for s in scenes),
         *(f"{d}/{s}" for d in per_scene for s in (scenes[0], scenes[2]))])
    assert sorted(rank1) == sorted(f"{d}/{scenes[1]}" for d in per_scene)
    assert sorted(want) == sorted({**rank0, **rank1})
    for name, blob in {**rank0, **rank1}.items():
        assert blob == want[name], name


def test_a_ragged_batch_takes_fewer_ranks(two_ranks):
    _, records = two_ranks
    evals = {r: {save.rsplit("_rank", 1)[0]: names for save, names in records[r]}
             for r in (0, 1)}
    for driver in EVALS:
        assert evals[0][driver] == ["synth005", "synth007"]
        assert evals[1][driver] == ["synth006"]


def test_the_validation_eval_runs_on_every_rank(two_ranks):
    work, records = two_ranks
    for r in (0, 1):
        train = [names for save, names in records[r] if save.startswith("train_rank")]
        assert train == [["synth002", "synth004"] if r == 0 else ["synth003"]]
    assert os.path.isfile(work / "train_rank0" / "model_best")
    assert not os.path.exists(work / "train_rank1" / "model_best")


@pytest.mark.parametrize("n,bs,world,pad_last,want", [
    # 3 scenes, batch 2, 2 ranks: (0 | 1), then 2 alone on rank 0
    (3, 2, 2, False, {0: [([0], 1), ([2], 1)], 1: [([1], 1)]}),
    # the RCNN driver's padded last batch: (2 | 2-padding) -> rank 1 idle
    (3, 2, 2, True, {0: [([0], 1), ([2], 1)], 1: [([1], 1)]}),
    # batch 8 over 4 ranks (train.sh's validation eval), then 2 scenes on 2
    (10, 8, 4, False, {0: [([0, 1], 2), ([8], 1)], 1: [([2, 3], 2), ([9], 1)],
                       2: [([4, 5], 2)], 3: [([6, 7], 2)]}),
    # 6 does not divide over 4: 3 ranks of 2
    (6, 6, 4, False, {0: [([0, 1], 2)], 1: [([2, 3], 2)], 2: [([4, 5], 2)], 3: []}),
    # padding inside a rank's block stays: 5 scenes, batch 4, 2 ranks
    (5, 4, 2, True, {0: [([0, 1], 2), ([4, 4], 1)], 1: [([2, 3], 2)]}),
    # world 1: the batches themselves
    (5, 2, 1, True, {0: [([0, 1], 2), ([2, 3], 2), ([4, 4], 1)]}),
])
def test_eval_blocks_follow_the_jax_re_mesh(n, bs, world, pad_last, want):
    for r in range(world):
        got = [(idx.tolist(), real) for idx, real in
               ddp.eval_blocks(n, bs, pad_last, rank_=r, world_=world)]
        assert got == want[r], r
    assert [ddp.eval_ranks(m, 4) for m in (1, 2, 3, 4, 5, 6, 8)] == [1, 2, 3, 4, 1, 3, 4]
