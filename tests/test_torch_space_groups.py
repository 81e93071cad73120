"""The ``space`` axis with data groups: four ranks in the layout ``(n_data,
n_space) = (2, 2)`` (JAX's own spatial test runs (2, 4)), against the
port's one process on the same global batch of two scenes, in f64.

Ranks 0-1 hold scene 0, split along x, ranks 2-3 scene 1.  The loss
normalisers and the logged terms sum over a rank's data group (ranks 0
and 2, or 1 and 3), BatchNorm moments and gradients over all four.  The
anchor sample is drawn once on the whole batch and each data group takes
its scene's rows; drop-path is off (the data groups draw their own masks).
Cases of ``torch_space_cases.py``: the narrow Swin OBB at 66 x 8 x
24 and ``resnet_tiny`` AABB at 32 x 40 x 40 (BatchNorm over the four slabs of two
scenes).  Read as there: each rank's head outputs and proposals against
its scene's of the one process within 1e-10 (the keep-set, ``level_idx``
and the counts equal), the train metrics, the gradients summed over the
world, the updated weights and running statistics within 1e-10, and the
four ranks' weights after the step bit-equal.
"""

import pytest
import torch
import torch_space_cases as cases

from nerf_rpn_tpu_torch.parallel import ddp

CASES = ("swin_obb_66", "resnet_tiny_aabb_32")


def _case(name, groups=None):
    model, cfg, batch = cases.setup(name)
    indices = cases.sample(cfg, batch, cases.CASES[name]["shape"])
    if groups is not None:
        d = groups.data_index
        indices = [t[d:d + 1] for t in indices]
    return cases.run_case(name, groups, indices, drop_path=False)


def _ranks(work):
    torch.set_num_threads(cases.THREADS)
    groups = ddp.space_groups()
    for name in CASES:
        cases.rank_results(work, name, _case(name, groups))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("space_groups")
    join = cases.launch_in_background(work, _ranks, n_ranks=(4,))
    threads = torch.get_num_threads()
    torch.set_num_threads(cases.THREADS)
    try:  # the references, while the ranks run
        alone = {name: _case(name) for name in CASES}
    finally:
        torch.set_num_threads(threads)
        join()
    ranks = {name: [torch.load(f"{work}/{name}_rank{r}.pt", weights_only=False)
                    for r in range(4)] for name in CASES}
    return ranks, alone


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("rank", range(4))
def test_eval_is_the_one_process_scene(runs, name, rank):
    got, want = runs[0][name][rank], runs[1][name]
    d = rank // 2
    for part in ("obj", "dl"):
        for g, w in zip(got[part], want[part]):
            assert cases.rel(g, w[d:d + 1]) <= 1e-10, (part, cases.rel(g, w[d:d + 1]))
    gp, wp = got["proposals"], want["proposals"]
    assert torch.equal(gp["valid"], wp["valid"][d:d + 1]) and wp["valid"][d].sum() > 20
    assert torch.equal(gp["level_idx"], wp["level_idx"][d:d + 1])
    for k in ("boxes", "scores"):
        assert cases.rel(gp[k], wp[k][d:d + 1]) <= 1e-10, (k, cases.rel(gp[k], wp[k][d:d + 1]))


@pytest.mark.parametrize("name", CASES)
def test_train_step_is_the_one_process(runs, name):
    want = runs[1][name]
    for got in runs[0][name]:
        assert got["ranks_equal"]
        for k, w in want["metrics"].items():
            assert abs(got["metrics"][k] - w) <= 1e-10 * abs(w), (k, got["metrics"][k], w)
    got = runs[0][name][0]
    for n, w in want["grads"].items():
        assert cases.rel(got["grads"][n], w) <= 1e-10, (n, cases.rel(got["grads"][n], w))
    for k, w in want["state"].items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got["state"][k], w), k
        else:
            err = cases.rel(got["state"][k], w, 1e-30 if "running_" in k else 1.0)
            assert err <= 1e-10, (k, err)
