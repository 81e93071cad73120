"""``scripts/nccl_smoke.py``, the port's four-card NCCL run, rehearsed on
four gloo CPU ranks through the same functions, with the devices and the
backend as their arguments (its space axis, (c), in
``test_torch_nccl_smoke_space.py``, so that ``--dist loadfile`` runs the
two files on two workers).

- The script raises, and does not skip, without four CUDA devices
  (``require_cards``, ``main``).
- (a) ``data_parallel``: phase 25's Swin-S RPN, FCOS and RCNN fine-tune
  cases, cut as ``nccl_smoke_cases.CONFIG_DP`` says, two scenes a rank (the
  RCNN one), against one process of the global batch: the ranks bit-equal,
  the readings within ``DDP_LIMITS``.  Not timed.
- (b) ``driver_argvs``: the drivers' arguments parse with each driver's own
  parser, and the global batches split over four ranks.

The checks are ``chip_smoke.py``'s: a failed one exits.  On the CPU the
ranks launch no kernel, and the checks expect none there.
"""

import pytest
import torch

from nccl_smoke_cases import CONFIG_DP, CPU4, nccl_smoke, rehearsal


def test_the_script_raises_without_four_cuda_devices():
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        nccl_smoke.require_cards(torch)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        nccl_smoke.main([])


def test_driver_arguments_parse_and_split_over_four_ranks(tmp_path):
    from nerf_rpn_tpu_torch.cli import common, run_rpn, run_rpn_detect
    from nerf_rpn_tpu_torch.parallel import ddp

    argv = nccl_smoke.driver_argvs(str(tmp_path), "0-3")
    train = run_rpn.parse_args(argv["rpn train"])
    assert (train.batch_size, train.bf16, train.rotated_bbox, train.normalize_density,
            train.backbone_type, ddp.parse_gpus(train.gpus)) == (8, True, True, True, "swin_s",
                                                                  [0, 1, 2, 3])
    assert common.local_batch_size(train.batch_size, 4) == 2
    ev = run_rpn.parse_args([*argv["rpn eval"], "--batch_size", "8", "--gpus", "0-3"])
    assert ev.mode == "eval" and ev.checkpoint.endswith("model_best")
    rcnn = run_rpn_detect.parse_args(argv["rcnn train"])
    assert (rcnn.fine_tune, rcnn.rotated_bbox, rcnn.is_add_layer, rcnn.is_flatten,
            rcnn.resolution, rcnn.batch_size) == (True, True, True, True, 200,
                                                   nccl_smoke.RCNN_BATCH)
    assert common.local_batch_size(rcnn.batch_size, 4) == 1


def test_data_parallel_on_four_gloo_ranks(tmp_path, monkeypatch):
    with rehearsal(monkeypatch, CONFIG_DP):
        rows = nccl_smoke.data_parallel(torch, CPU4, "gloo", str(tmp_path / "dp"),
                                        config=CONFIG_DP, step_reps=0,
                                        rendezvous=str(tmp_path))
    assert [r["case"] for r in rows] == list(nccl_smoke.DP_CASES)
    assert [r["scenes"] for r in rows] == [8, 8, 4]
    assert rows[0]["grad_mib"] > 0 and len(rows[0]["grad_all_reduce_ms"]) == 4
    assert rows[2]["fg_rois"] > 0 and rows[2]["fg_rois"] + rows[2]["bg_rois"] == 4 * 128
