"""The small cases on which ``test_torch_nccl_smoke_plan.py`` and
``test_torch_nccl_smoke_space.py`` rehearse ``scripts/nccl_smoke.py`` on
four gloo CPU ranks, and the rehearsal's set-up.

``CONFIG_DP`` cuts phase 25's cases to ``resnet_tiny`` (the RPN: train-mode
BatchNorm, whose moments go over the world) and ``swin_t`` (FCOS and the
RCNN, whose head takes 256 channels) at 32^3.  ``CONFIG_SPACE`` cuts phases
32-34 to 32 x 16 x 16: the RPN and the FCOS evals on ``resnet_tiny``, the
train steps of FCOS and the RCNN and the RCNN eval on ``swin_t`` (two of
four ranks hold no window of its stage 0 and later: 8 tokens, two window
columns), VGG as the phases run it; the evals in f32 (the CPU's bf16 rounds
a slab and the whole grid at other points; the phases' bf16 cases keep
their names, which their checks read).
"""

import contextlib
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import nccl_smoke  # noqa: E402

CPU4 = [torch.device("cpu")] * 4
SPACE_SHAPE = (32, 16, 16)
F32_EVALS = {"bf16 aabb": ("float32", False), "f32 aabb": ("float32", False)}
CONFIG_DP = {"DDP_CASES": {
    "swin_s rpn obb": {"head": "rpn", "backbone": "resnet_tiny", "shape": (32, 32, 32)},
    "swin_s fcos obb": {"head": "fcos", "backbone": "swin_t", "shape": (32, 32, 32)},
    "swin_s rcnn obb": {"head": "rcnn", "backbone": "swin_t", "shape": (32, 32, 32)}}}
CONFIG_SPACE = {
    "DDP_CASES": {
        "swin_s rpn obb": {"head": "rpn", "backbone": "resnet_tiny", "shape": SPACE_SHAPE},
        "swin_s fcos obb": {"head": "fcos", "backbone": "swin_t", "shape": SPACE_SHAPE},
        "swin_s rcnn obb": {"head": "rcnn", "backbone": "swin_t", "shape": SPACE_SHAPE}},
    "SPACE_SIZE": SPACE_SHAPE, "SPACE_BACKBONE": "resnet_tiny",
    "SPACE_FCOS_BACKBONE": "resnet_tiny", "SPACE_FCOS_SIZE": SPACE_SHAPE, "SPACE_REPS": 1,
    "SPACE_TRAIN_REPS": 1, "SPACE_EVALS": F32_EVALS,
    "SPACE_FCOS_EVALS": {f"fcos {k}": v for k, v in F32_EVALS.items()},
    "SPACE_VGG_EVALS": {f"vgg {k}": v for k, v in F32_EVALS.items()},
}


@contextlib.contextmanager
def rehearsal(monkeypatch, config):
    """The test process on 2 threads; after it, ``chip_smoke``'s settings
    that ``config`` names and the ``torch.cuda`` functions that the
    script's CPU stand-ins replace as they were."""
    for fn in ("synchronize", "reset_peak_memory_stats", "max_memory_allocated",
               "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, getattr(torch.cuda, fn))
    for k in config:
        monkeypatch.setattr(nccl_smoke.cs, k, getattr(nccl_smoke.cs, k))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
