"""The ``space`` axis on the VGG backbone: the anchor RPN's eval and train
steps (``make_rpn_eval_step`` / ``make_rpn_train_step(..., space=groups)``)
on ``vgg_AF`` with ``input_size`` 160, each scene's x extent split over two
ranks, ``(n_data, n_space) = (1, 2)``.

Spawned gloo ranks (a ``file://`` rendezvous in the test's temporary
directory) run ``torch_space_fcos_cases.VGG_CASE`` -- 40 x 16 x 16, whose
2^3 ceil-mode pools meet 10, 5 and 3 rows, a window straddling the split
and windows past the global edge -- on their slabs of the global batch; the
port's one process runs the same steps on the whole batch meanwhile.  In
f64, as ``test_torch_space_steps.py`` holds the Swin and ResNet cases: the
gathered head outputs within 1e-10 of their largest entry, the keep-set,
``level_idx`` and the counts equal, boxes, scores and voxel scores within
1e-10; the loss terms and norms within 1e-10 (relative), the ranks'
gradients summed over the world within 1e-10 of each leaf's largest entry,
the updated parameters (to max(1, the leaf's largest)) and running
statistics within 1e-10, and the ranks' weights after the step bit-equal.
A leaf whose gradient is zero in exact arithmetic (the convs' biases before
a train-mode BatchNorm) is held to 1e-10 of the model's largest gradient
entry (``torch_space_cases.grad_rel``).
The anchor sample is drawn on each rank from the one process's seed.

And the ranks run the port's ``vgg_AF`` RPN eval of JAX's weights on two
scenes of the same grid: JAX's own ``make_rpn_eval_step`` under
``make_mesh_2d(1, 2)`` with the grids put by ``grid_sharding``, the port on
its two ranks with the weights carried by ``weights.from_jax_params``, in
f32.  On each rank: ``valid`` equal, scores within 1e-5 and boxes within
1e-4 (absolute), the tolerances of ``test_torch_space_steps.py``'s
comparison.
"""

import numpy as np
import pytest
import torch
import torch_space_cases as base
import torch_space_fcos_cases as cases
from test_torch_space_fcos import jax_space_eval, jax_variables

from nerf_rpn_tpu.models.nerf_rpn import NeRFRPN as JNeRFRPN
from nerf_rpn_tpu.models.rpn import RPNConfig as JRPNConfig
from nerf_rpn_tpu.train.steps import make_rpn_eval_step as jax_eval_step
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN

NAME = cases.VGG_CASE
SHAPE = cases.VGG_SPEC["shape"]


def write_jax_case(work):
    """JAX's ``vgg_AF`` RPN, weights and batch; the weights and the batch
    written for the ranks."""
    model = JNeRFRPN(backbone_type="vgg_AF", resolution=160, conv_depth=1)
    params, stats = jax_variables(model, SHAPE, seed=7)
    port = NeRFRPN("vgg_AF", conv_depth=1, resolution=160)
    torch.save(weights.from_jax_params(params, stats, port.backbone), f"{work}/vgg_weights.pt")
    grids = base.grids(SHAPE, seed=8).numpy().astype(np.float32)
    batch = {"grids": grids, "ori_sizes": np.array([SHAPE, [38, 16, 14]], np.int32)}
    torch.save({k: torch.from_numpy(v) for k, v in batch.items()}, f"{work}/vgg_batch.pt")
    return model, params, stats, batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and the one process's; the ranks' evals of JAX's
    weights and JAX's."""
    work = tmp_path_factory.mktemp("space_vgg")
    jmodel, params, stats, batch = write_jax_case(work)
    join = base.launch_in_background(work, cases.vgg_ranks)
    threads = torch.get_num_threads()
    torch.set_num_threads(base.THREADS)
    try:  # the references, while the ranks run
        alone = base.run_case(NAME, spec=cases.VGG_SPEC)
        step = jax_eval_step(jmodel, JRPNConfig(**cases.VGG_JAX_CFG), SHAPE)
        jax_out = jax_space_eval(step, params, stats, batch)
    finally:
        torch.set_num_threads(threads)
        join()
    ranks = [torch.load(f"{work}/{NAME}_rank{r}.pt", weights_only=False) for r in (0, 1)]
    evals = [torch.load(f"{work}/vgg_eval_rank{r}.pt", weights_only=False) for r in (0, 1)]
    return ranks, alone, evals, jax_out


def test_the_ceil_mode_pools_straddle_the_split():
    """Level 0's 10 rows split 5 / 5 into the first pool's 5 outputs (3 /
    2): rank 0's third window reads its row 4 and rank 1's row 5; the
    second pool's 3 outputs read one row and the -inf past the edge."""
    model = NeRFRPN("vgg_AF", conv_depth=1, resolution=160)
    groups = base.sp.SpaceGroups(1, 2, 0, 0)
    slabs = model.level_slabs(base.sp.input_slab(groups, SHAPE[0]))
    assert [s.bounds for s in slabs] == [((0, 5), (5, 10)), ((0, 3), (3, 5)),
                                         ((0, 2), (2, 3)), ((0, 1), (1, 2))]


@pytest.mark.parametrize("rank", (0, 1))
def test_eval_head_outputs_are_the_one_process(runs, rank):
    got, want = runs[0][rank], runs[1]
    for part in ("obj", "dl"):
        for g, w in zip(got[part], want[part]):
            assert g.shape == w.shape
            assert base.rel(g, w) <= 1e-10, (part, base.rel(g, w))


@pytest.mark.parametrize("rank", (0, 1))
def test_eval_proposals_are_the_one_process(runs, rank):
    got, want = runs[0][rank]["proposals"], runs[1]["proposals"]
    assert torch.equal(got["valid"], want["valid"]) and want["valid"].sum() > 20
    assert torch.equal(got["level_idx"], want["level_idx"])
    assert torch.equal(got["valid"].sum(1), want["valid"].sum(1))
    for k in ("boxes", "scores", "voxel_scores"):
        for g, w in zip(*(v if isinstance(v, list) else [v] for v in (got[k], want[k]))):
            assert base.rel(g, w) <= 1e-10, (k, base.rel(g, w))


def test_train_loss_terms_and_norms(runs):
    want = runs[1]["metrics"]
    for got in runs[0]:
        assert set(got["metrics"]) == set(want) and want["loss"] > 0
        for k, w in want.items():
            assert abs(got["metrics"][k] - w) <= 1e-10 * abs(w), (k, got["metrics"][k], w)


def test_train_gradients_sum_to_the_one_process(runs):
    want, got = runs[1]["grads"], runs[0][0]["grads"]
    assert set(got) == set(want)
    top = max(w.abs().max().item() for w in want.values())
    for n, w in want.items():
        assert base.grad_rel(got[n], w, top) <= 1e-10, (n, base.grad_rel(got[n], w, top))


def test_train_updated_weights_and_running_statistics(runs):
    want, got = runs[1]["state"], runs[0][0]["state"]
    assert any("running_" in k for k in want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], w), k
        else:
            err = base.rel(got[k], w, 1e-30 if "running_" in k else 1.0)
            assert err <= 1e-10, (k, err)


def test_ranks_are_bit_equal_after_the_step(runs):
    assert all(r["ranks_equal"] for r in runs[0])


@pytest.mark.parametrize("rank", (0, 1))
def test_vgg_eval_matches_jax_space_path(runs, rank):
    got, want = runs[2][rank], runs[3]
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    assert want["valid"].sum() > 10
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0, atol=1e-4)
