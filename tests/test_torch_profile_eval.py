"""Torch port: the eval-step profiler's host-side pieces (no GPU here).

``cli/profile_eval.py`` times the GPU; on the CPU it must refuse to run,
and its device-busy time is the union of the kernel intervals (overlaps
counted once, gaps not at all).
"""

import pytest
import torch

from nerf_rpn_tpu_torch.cli import profile_eval


@pytest.mark.parametrize("spans,want", [([], 0.0),
                                        ([(0, 10), (5, 15), (20, 30)], 25.0),
                                        ([(20, 30), (0, 40), (41, 42)], 41.0)])
def test_busy_time_is_the_union_of_kernel_intervals(spans, want):
    assert profile_eval._union_us(spans) == want


def test_profile_eval_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="GPU"):
        profile_eval.main(["--scenes", "1"])
