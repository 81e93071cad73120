"""Torch port: the eval-step profiler's host-side pieces (no GPU here).

``cli/profile_eval.py`` times the GPU; on the CPU it must refuse to run,
and its device-busy time is the union of the kernel intervals (overlaps
counted once, gaps not at all; ``utils/profiling.span_union_us``).
"""

import pytest
import torch

from nerf_rpn_tpu_torch.cli import profile_eval
from nerf_rpn_tpu_torch.utils.profiling import span_union_us


@pytest.mark.parametrize("spans,want", [([], 0.0),
                                        ([(0, 10), (5, 15), (20, 30)], 25.0),
                                        ([(20, 30), (0, 40), (41, 42)], 41.0)])
def test_busy_time_is_the_union_of_kernel_intervals(spans, want):
    assert span_union_us(spans) == want


def test_profile_eval_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="GPU"):
        profile_eval.main(["--scenes", "1"])


class _Event:
    """A stand-in for ``torch.cuda.Event``: 1 ms between two records."""

    def __init__(self, enable_timing=True):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


@pytest.mark.parametrize("backbone,groups", [
    ("resnet_tiny", {"stem", "stage0", "stage1", "stage2", "stage3", "fpn neck", "head"}),
    ("vgg_AF", {"stem", "stage0", "stage1", "stage2", "stage3", "fpn neck", "head"}),
    ("swin_t", {"stage0 blocks", "stage1 merge", "stage1 blocks", "stage2 merge",
                "stage2 blocks", "stage3 merge", "stage3 blocks", "fpn neck", "head"}),
])
def test_layer_times_covers_every_group_of_each_backbone(monkeypatch, backbone, groups):
    """The per-layer timing of ``profile_eval`` finds the CNN backbones'
    stem, stages and FPN neck (methods and modules alike), runs a forward
    through them, and leaves the model as it was."""
    from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN

    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    model = NeRFRPN(backbone, conv_depth=1).eval()
    x = torch.rand((1, 32, 32, 32, 4))
    with torch.no_grad():
        want = model(x)[1]
        times = profile_eval.layer_times(model, lambda: model(x), scenes=1)
        assert set(times) == groups
        assert all(v >= 1.0 for v in times.values())
        assert "stem" not in vars(model.backbone)  # the method is the class's again
        assert all(torch.equal(a, b) for a, b in zip(model(x)[1], want))
