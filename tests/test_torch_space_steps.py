"""The ``space`` axis (``parallel/space.py``) on two ranks, ``(n_data,
n_space) = (1, 2)``: each scene's x extent split over the ranks.

Two ranks (spawned, gloo, a ``file://`` rendezvous in the test's temporary
directory, started once for the whole file) run each case of
``torch_space_cases.py`` through ``make_rpn_eval_step`` /
``make_rpn_train_step(..., space=groups)`` on their slabs of the global
batch (``space.shard_batch``); the port's one process runs the same steps on
the whole batch.  In f64:

- eval: each level's gathered head outputs within 1e-10 of the level's
  largest entry, the keep-set (``valid``), ``level_idx`` and the counts
  equal, boxes, scores and voxel scores within 1e-10 (relative);
- train: the loss terms, ``grad_norm`` and ``param_norm`` within 1e-10
  (relative), the ranks' gradients summed over the world within 1e-10 of
  each leaf's largest entry, the updated parameters (to max(1, the leaf's
  largest)) and running statistics within 1e-10, and the two ranks'
  weights after the step bit-equal.  The anchor sample and the drop-path
  masks are drawn on each rank from the one process's seeds: a space group
  draws alike.

The same ranks run ``torch.autograd.gradcheck`` (f64) of the three
exchanges -- ``halo_x``, ``reshard_x`` (a wrapped map, to an empty slab and
from one) and ``gather_x`` -- each between a scatter of a global input to
the slabs (whose backward sums the slabs' gradients over the ranks) and a
gather of the outputs, so that every rank checks the same global function
in lockstep.

And they run the eval step of JAX's own space path, the ``resnet_tiny``
model of ``tests/test_multidevice.py`` (32^3, ``conv_depth`` 1, one anchor
a level), on two scenes: JAX under ``make_mesh_2d(1, 2)`` with the grids
put by ``grid_sharding`` (the conftest gives 8 CPU devices), the port on
its two ranks with the weights carried by ``weights.from_jax_params``, in
f32.  On each rank: ``valid`` equal, scores within 1e-5 (absolute: the
whole-step tolerance of ``test_torch_resnet_slice.py``), boxes within 1e-4
(JAX's own tolerance between its space path and one device,
``tests/test_spatial_sharding.py``).
"""

import jax
import numpy as np
import pytest
import torch
import torch_space_cases as cases
from jax.sharding import NamedSharding, PartitionSpec as P

from nerf_rpn_tpu.models.nerf_rpn import NeRFRPN as JNeRFRPN
from nerf_rpn_tpu.models.rpn import RPNConfig as JRPNConfig
from nerf_rpn_tpu.parallel.mesh import DATA_AXIS, SPACE_AXIS, grid_sharding, make_mesh_2d
from nerf_rpn_tpu.train.state import TrainState as JTrainState
from nerf_rpn_tpu.train.steps import make_rpn_eval_step as jax_eval_step
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN
from torch_space_cases import ONE_ANCHOR_NMS, ONE_ANCHOR_RATIOS, ONE_ANCHOR_SHAPE, ONE_ANCHOR_SIZES


def jax_case():
    """JAX's model, config, state and a two-scene batch (f32).  The
    variables are drawn from numpy in the shapes of ``model.init``
    (``jax.eval_shape``: an init runs for seconds on the CPU): kernels
    N(0, 1 / fan_in), the head's N(0, 0.01), biases, scales and running
    statistics near their starting values."""
    model = JNeRFRPN(backbone_type="resnet_tiny", resolution=32, conv_depth=1,
                     num_anchors=1)
    cfg = JRPNConfig(anchor_sizes=ONE_ANCHOR_SIZES, aspect_ratios=ONE_ANCHOR_RATIOS,
                     **ONE_ANCHOR_NMS)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                            jax.random.PRNGKey(0), jax.numpy.zeros((1, *ONE_ANCHOR_SHAPE, 4)))
    rng = np.random.default_rng(2)

    def draw(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if name.endswith("kernel"):
            std = 0.01 if "rpn_head" in name else np.prod(leaf.shape[:-1]) ** -0.5
            return (std * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name.endswith("var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        base = 1.0 if name.endswith("scale") else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    state = JTrainState(step=0, params=v["params"], batch_stats=v["batch_stats"],
                        opt_state=None, tx=None)
    g = cases.grids(ONE_ANCHOR_SHAPE, seed=4).numpy().astype(np.float32)
    return model, cfg, state, {"grids": g, "ori_sizes": np.full((2, 3), 32, np.int32)}


def _jax_eval(model, cfg, state, batch):
    step = jax_eval_step(model, cfg, ONE_ANCHOR_SHAPE)
    mesh = make_mesh_2d(1, 2)
    with mesh:
        put = {k: jax.device_put(v, grid_sharding(mesh) if v.ndim == 5 else
                                 NamedSharding(mesh, P(DATA_AXIS)))
               for k, v in batch.items()}
        # the grid really is x-sharded
        assert put["grids"].sharding.spec == P(DATA_AXIS, SPACE_AXIS)
        want = step(jax.device_put(state, NamedSharding(mesh, P())), put)
    return {k: np.asarray(want[k]) for k in ("valid", "scores", "boxes")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and the one process's, by case; the ranks'
    gradchecks; the ranks' evals of JAX's model and JAX's."""
    work = tmp_path_factory.mktemp("space_steps")
    model, cfg, state, batch = jax_case()
    port = NeRFRPN("resnet_tiny", conv_depth=1, num_anchors=1, resolution=32)
    torch.save(weights.from_jax_params(state.params, state.batch_stats, port.backbone),
               f"{work}/weights.pt")
    torch.save({k: torch.from_numpy(v) for k, v in batch.items()}, f"{work}/batch.pt")
    join = cases.launch_in_background(work, cases.ranks_1x2)
    threads = torch.get_num_threads()
    torch.set_num_threads(cases.THREADS)
    try:  # the references, while the ranks run
        alone = {name: cases.run_case(name) for name in cases.CASES}
        jax_out = _jax_eval(model, cfg, state, batch)
    finally:
        torch.set_num_threads(threads)
        join()
    ranks = {name: [torch.load(f"{work}/{name}_rank{r}.pt", weights_only=False)
                    for r in (0, 1)] for name in cases.CASES}
    checks = [torch.load(f"{work}/gradchecks_rank{r}.pt") for r in (0, 1)]
    evals = [torch.load(f"{work}/eval_rank{r}.pt", weights_only=False) for r in (0, 1)]
    return ranks, alone, checks, evals, jax_out


@pytest.mark.parametrize("name", cases.CASES)
@pytest.mark.parametrize("rank", (0, 1))
def test_eval_head_outputs_are_the_one_process(runs, name, rank):
    got, want = runs[0][name][rank], runs[1][name]
    for part in ("obj", "dl"):
        for g, w in zip(got[part], want[part]):
            assert g.shape == w.shape
            assert cases.rel(g, w) <= 1e-10, (part, cases.rel(g, w))


@pytest.mark.parametrize("name", cases.CASES)
@pytest.mark.parametrize("rank", (0, 1))
def test_eval_proposals_are_the_one_process(runs, name, rank):
    got, want = runs[0][name][rank]["proposals"], runs[1][name]["proposals"]
    assert torch.equal(got["valid"], want["valid"]) and want["valid"].sum() > 20
    assert torch.equal(got["level_idx"], want["level_idx"])
    assert torch.equal(got["valid"].sum(1), want["valid"].sum(1))
    for k in ("boxes", "scores", "voxel_scores"):
        for g, w in zip(*(v if isinstance(v, list) else [v] for v in (got[k], want[k]))):
            assert cases.rel(g, w) <= 1e-10, (k, cases.rel(g, w))


@pytest.mark.parametrize("name", cases.CASES)
def test_train_loss_terms_and_norms(runs, name):
    want = runs[1][name]["metrics"]
    for got in runs[0][name]:
        assert set(got["metrics"]) == set(want) and want["loss"] > 0
        for k, w in want.items():
            assert abs(got["metrics"][k] - w) <= 1e-10 * abs(w), (k, got["metrics"][k], w)


@pytest.mark.parametrize("name", cases.CASES)
def test_train_gradients_sum_to_the_one_process(runs, name):
    want = runs[1][name]["grads"]
    got = runs[0][name][0]["grads"]
    assert set(got) == set(want)
    for n, w in want.items():
        assert cases.rel(got[n], w) <= 1e-10, (n, cases.rel(got[n], w))


@pytest.mark.parametrize("name", cases.CASES)
def test_train_updated_weights_and_running_statistics(runs, name):
    want = runs[1][name]["state"]
    got = runs[0][name][0]["state"]
    assert any("running_" in k for k in want) == name.startswith("resnet")
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], w), k
        else:
            err = cases.rel(got[k], w, 1e-30 if "running_" in k else 1.0)
            assert err <= 1e-10, (k, err)


@pytest.mark.parametrize("name", cases.CASES)
def test_ranks_are_bit_equal_after_the_step(runs, name):
    assert all(r["ranks_equal"] for r in runs[0][name])


@pytest.mark.parametrize("kind", cases.EXCHANGES)
@pytest.mark.parametrize("rank", (0, 1))
def test_exchange_gradcheck(runs, kind, rank):
    assert runs[2][rank][kind] is True, runs[2][rank][kind]


@pytest.mark.parametrize("rank", (0, 1))
def test_resnet_tiny_eval_matches_jax_space_path(runs, rank):
    got, want = runs[3][rank], runs[4]
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    assert want["valid"].sum() > 10
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0, atol=1e-4)
