"""``scripts/nccl_smoke.py``'s space axis, (c), rehearsed on four gloo CPU
ranks through ``space_axis``, the function the script calls on four cards:
phases 32-34's eval and train cases at ``(n_data, n_space) = (1, 4)`` and
``(2, 2)``, cut as ``nccl_smoke_cases.CONFIG_SPACE`` says, each against one
process by those phases' rules (``chip_smoke.check_space_axis``,
``check_space_fcos_vgg``, ``check_space_rcnn``: a failed check exits).  At
(1, 4) two of the four ranks hold no window of the Swin's stage 0 and
later, and no row of ResNet's and VGG's deeper levels, so
``space.keep_graph_empty`` carries them through every phase; at (2, 2)
each data group evaluates the eval's scene and trains on one of the steps'
two scenes.  On the CPU the ranks launch no kernel, and the checks expect
none there.
"""

import torch

from nccl_smoke_cases import CONFIG_SPACE, CPU4, nccl_smoke, rehearsal


def test_space_axis_on_four_gloo_ranks(tmp_path, monkeypatch):
    with rehearsal(monkeypatch, CONFIG_SPACE):
        paths = nccl_smoke.space_axis(torch, CPU4, "gloo", str(tmp_path / "space"),
                                      config=CONFIG_SPACE, rendezvous=str(tmp_path))
    for layout in ("1x4", "2x2"):
        for phase in ("rpn", "fcos vgg", "rcnn"):
            ranks = [k for k in paths if k.startswith(f"space gloo {layout} {phase} ")]
            assert len(ranks) >= 4 * 2, (layout, phase, ranks)
