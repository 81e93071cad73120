"""Torch port: ``utils/debug.py`` and ``utils/profiling.py``.

``inspect_anchor_gt_iou`` against the JAX package's on the anchors of a
32^3 scene (4 levels, 13 anchors a voxel) with AABB and OBB targets: the
same printed lines, the counts exact, the mean best IoU within 1e-6.  On the
CPU: ``trace`` writes a trace file, ``benchmark_fn`` threads its carry and
returns a positive time, ``nan_check`` passes a finite output and names the
leaf of a non-finite one.
"""

import glob
import json

import numpy as np
import pytest
import torch

from nerf_rpn_tpu.utils.debug import inspect_anchor_gt_iou as jax_inspect
from nerf_rpn_tpu_torch.models.rpn import RPNConfig, build_level_tables
from nerf_rpn_tpu_torch.utils import profiling
from nerf_rpn_tpu_torch.utils.debug import inspect_anchor_gt_iou


def _targets(rng, n, rotated):
    ctr = rng.uniform(6, 26, (n, 3))
    size = rng.uniform(3, 12, (n, 3))
    if rotated:
        return np.concatenate([ctr, size, rng.uniform(-np.pi / 2, np.pi / 2, (n, 1))], 1)
    return np.concatenate([ctr - size / 2, ctr + size / 2], 1).astype(np.float32)


@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
def test_inspect_anchor_gt_iou_matches_jax(rotated):
    anchors, *_ = build_level_tables(RPNConfig(), (32, 32, 32), [(s,) * 3 for s in (8, 4, 2, 1)])
    assert anchors.shape == (13 * (8 ** 3 + 4 ** 3 + 2 ** 3 + 1), 6)
    rng = np.random.default_rng(0)
    targets = [_targets(rng, n, rotated) for n in (3, 1, 5)]
    # one gt box that is an anchor, so the scene has positives
    a = anchors[1000].astype(np.float64)
    exact = (np.concatenate([(a[:3] + a[3:]) / 2, a[3:] - a[:3], [0.0]]) if rotated else a)
    targets[0] = np.concatenate([targets[0], exact[None].astype(targets[0].dtype)])
    got_lines, want_lines = [], []
    got = inspect_anchor_gt_iou(anchors, targets, print_fn=got_lines.append, device="cpu")
    want = jax_inspect(anchors, targets, print_fn=want_lines.append)
    assert got_lines == want_lines
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["num_pos_anchors"] == w["num_pos_anchors"]
        assert g["num_neg_anchors"] == w["num_neg_anchors"]
        assert abs(g["mean_best_iou"] - w["mean_best_iou"]) <= 1e-6
    assert any(s["num_pos_anchors"] > 0 for s in got)


def test_trace_writes_a_trace_file(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        (x @ x).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


def test_benchmark_fn_threads_the_carry():
    seen = []

    def step(x, carry):
        seen.append(float(carry))
        return carry + (x * 0).sum() + 1

    t = profiling.benchmark_fn(step, torch.ones(8), warmup=2, reps=5)
    assert t > 0
    assert seen == [float(i) for i in range(7)]


def test_nan_check_names_the_leaf():
    def step(x):
        return {"loss": x.sum(), "parts": [x, {"count": torch.tensor(3)}]}

    checked = profiling.nan_check(step)
    out = checked(torch.ones(4))
    assert float(out["loss"]) == 4.0
    x = torch.ones(4)
    x[2] = float("nan")
    with pytest.raises(FloatingPointError, match=r"output\['loss'\]"):
        checked(x)

    def tail(x):
        return {"loss": torch.zeros(()), "parts": [torch.zeros(2), {"inf": x / 0}]}

    with pytest.raises(FloatingPointError, match=r"output\['parts'\]\[1\]\['inf'\]"):
        profiling.nan_check(tail)(torch.ones(2))


def test_inspect_anchor_gt_iou_defaults_to_the_gpu(monkeypatch):
    """Without ``device`` the IoUs run on the GPU, and without one it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    anchors, *_ = build_level_tables(RPNConfig(), (8, 8, 8), [(s,) * 3 for s in (2, 1)])
    with pytest.raises(RuntimeError, match="cuda"):
        inspect_anchor_gt_iou(anchors, [np.zeros((1, 6), np.float32)], print_fn=lambda _: None)
