"""The port's train-to-quality gate (``nerf_rpn_tpu_torch/cli/quality_gate.py``).

The fast tests hold its gates and its log parser to
``scripts/synthetic_quality_gate.py``'s.  The gate runs themselves train
``resnet_tiny`` from scratch for 60 epochs through the port's drivers on
the CPU -- minutes a combo -- so they are gated behind
``NERF_RPN_QUALITY_GATE=1``, as ``tests/test_synthetic_quality.py`` does::

    NERF_RPN_QUALITY_GATE=1 python -m pytest tests/test_torch_quality_gate.py -v

(on the card: ``python -m nerf_rpn_tpu_torch.cli.quality_gate --device cuda``).
"""

import os

import pytest

from nerf_rpn_tpu_torch.cli import quality_gate
from scripts import synthetic_quality_gate as jax_gate

gate = pytest.mark.skipif(
    os.environ.get("NERF_RPN_QUALITY_GATE") != "1",
    reason="minutes-long train-to-quality gate; set NERF_RPN_QUALITY_GATE=1",
)


def test_gates_are_the_scripts():
    assert set(quality_gate.GATES) == set(jax_gate.GATES) - {"rcnn"}
    for combo in quality_gate.GATES:
        assert quality_gate.GATES[combo] == jax_gate.GATES[combo], combo
        assert quality_gate.GATES_AP50[combo] == jax_gate.GATES_AP50[combo], combo


def test_recall_curve_parser_reads_the_drivers_log(tmp_path):
    log = tmp_path / "run.log"
    log.write_text("x INFO Top 256: Recall@50 0.1667  Recall@25 1.0000  AR 0.5\n"
                   "x INFO AP@50: 1.0000  AP@25: 1.0000\n"
                   "x INFO Top 256: Recall@50 1.0000  Recall@25 1.0000  AR 0.6\n")
    assert quality_gate.parse_recall_curve(str(log)) == [0.1667, 1.0]
    assert jax_gate.parse_recall_curve(str(log)) == [0.1667, 1.0]
    assert quality_gate.parse_recall_curve(str(tmp_path / "none.log")) == []


def test_unknown_combo_is_refused(tmp_path):
    with pytest.raises(ValueError, match="rcnn"):
        quality_gate.run_combo("rcnn", str(tmp_path), device="cpu")


def _run_gate(combo, tmp_path):
    ap25, ap50, r25, _, curve = quality_gate.run_combo(combo, str(tmp_path), device="cpu")
    print(f"{combo}: ap25={ap25:.4f} ap50={ap50:.4f} recall25={r25:.4f} curve={curve}")
    assert ap25 >= quality_gate.GATES[combo], (combo, ap25)
    assert ap50 >= quality_gate.GATES_AP50[combo], (combo, ap50)


@gate
@pytest.mark.parametrize("combo", ["rpn_aabb", "rpn_obb", "fcos_aabb", "fcos_obb"])
def test_quality_gate_on_the_cpu(combo, tmp_path):
    _run_gate(combo, tmp_path)


def test_deterministic_mode_sets_torch_and_cudnn(monkeypatch):
    """The card's gate runs torch's deterministic algorithms (one seed, one
    result): the helper turns on torch's mode and cuDNN's deterministic
    convolutions and gives cuBLAS a fixed workspace setting."""
    import torch

    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    was = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    try:
        quality_gate.use_deterministic_algorithms()
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    finally:
        torch.use_deterministic_algorithms(was[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was[1:]
