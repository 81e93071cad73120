"""The ``space`` axis on the FCOS detector: each scene's x extent split over
ranks in ``make_fcos_eval_step`` / ``make_fcos_train_step(...,
space=groups)``.

Spawned gloo ranks (a ``file://`` rendezvous in the test's temporary
directory) run each case of ``torch_space_fcos_cases.py`` on their slabs of
the global batch (``space.shard_batch``) at ``(n_data, n_space) = (1, 2)``,
then ``fcos_resnet_tiny_obb_32`` at ``(2, 2)``; the port's one process runs
the same steps on the whole batch meanwhile.  In f64:

- eval: the gathered, flattened head outputs (cls, reg, ctr) within 1e-10
  of their largest entry, the keep-set (``valid``), ``level_idx`` and the
  counts equal, boxes, scores and voxel scores within 1e-10 (relative);
  at (2, 2) a rank's scenes are its data group's of the one process's;
- train: the loss terms, ``dropped_positives``, ``grad_norm`` and
  ``param_norm`` within 1e-10 (relative), the ranks' gradients summed over
  the world within 1e-10 of each leaf's largest entry, the updated
  parameters (to max(1, the leaf's largest)) and the running statistics
  within 1e-10, and the ranks' weights after the step bit-equal.  A leaf
  whose gradient is zero in exact arithmetic -- a tower conv's bias before
  a GroupNorm of one channel a group (``resnet_tiny``'s 32 channels in 32
  groups), a conv's bias before a train-mode BatchNorm -- holds rounding
  (~1e-17); such a leaf (its largest entry below 1e-12 of the model's
  largest gradient entry) is held to 1e-10 of the model's largest gradient
  entry (``torch_space_cases.grad_rel``).

The same ranks run ``torch.autograd.gradcheck`` (f64) of the space group's
all-reduce (``space.all_reduce_sum``) and of the slab GroupNorm
(``layers.group_norm`` given slabs, and with one rank's slab empty), each
between a scatter of a global input and a gather of the outputs, as
``test_torch_space_steps.py`` checks the exchanges.

And they run the port's FCOS eval of JAX's weights, ``resnet_tiny`` at
32^3 with one tower conv, on two scenes: JAX's own ``make_fcos_eval_step``
under ``make_mesh_2d(1, 2)`` with the grids put by ``grid_sharding`` (the
conftest gives 8 CPU devices), the port on its two ranks with the weights
carried by ``weights.from_jax_params``, in f32.  On each rank: ``valid``
equal, scores within 1e-5 and boxes within 1e-4 (absolute), the
tolerances of ``test_torch_space_steps.py``'s RPN comparison -- the
proposals as sets (level, score and box), since near-equal scores of
random weights trade places between two implementations.
"""

import jax
import numpy as np
import pytest
import torch
import torch_space_cases as base
import torch_space_fcos_cases as cases
from jax.sharding import NamedSharding, PartitionSpec as P

from nerf_rpn_tpu.models.fcos import FCOSConfig as JFCOSConfig
from nerf_rpn_tpu.models.nerf_rpn import FCOSOverNeRF as JFCOSOverNeRF
from nerf_rpn_tpu.parallel.mesh import DATA_AXIS, SPACE_AXIS, grid_sharding, make_mesh_2d
from nerf_rpn_tpu.train.state import TrainState as JTrainState
from nerf_rpn_tpu.train.steps import make_fcos_eval_step as jax_eval_step
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.models.nerf_rpn import FCOSOverNeRF

LAYOUTS = [(name, "1x2", r) for name in cases.FCOS_CASES for r in (0, 1)] + \
    [(cases.FCOS_2X2, "2x2", r) for r in range(4)]


def jax_variables(model, shape, seed, head_std=0.01):
    """Variables in the shapes of ``model.init`` (``jax.eval_shape``; an
    init runs for seconds on the CPU), drawn from numpy: kernels N(0, 1 /
    fan_in), the head's N(0, ``head_std``), biases, scales and running
    statistics near their starting values (f32)."""
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                            jax.random.PRNGKey(0), jax.numpy.zeros((1, *shape, 4)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if name.endswith("kernel"):
            std = head_std if "_head" in name else np.prod(leaf.shape[:-1]) ** -0.5
            return (std * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name.endswith("var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        start = 1.0 if name.endswith("scale") else 0.0
        return (start + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return v["params"], v.get("batch_stats", {})


def jax_space_eval(step, params, batch_stats, batch):
    """``step(state, batch)`` under ``make_mesh_2d(1, 2)``, the grids
    x-sharded by ``grid_sharding``."""
    state = JTrainState(step=0, params=params, batch_stats=batch_stats, opt_state=None,
                        tx=None)
    mesh = make_mesh_2d(1, 2)
    with mesh:
        put = {k: jax.device_put(v, grid_sharding(mesh) if v.ndim == 5 else
                                 NamedSharding(mesh, P(DATA_AXIS)))
               for k, v in batch.items()}
        assert put["grids"].sharding.spec == P(DATA_AXIS, SPACE_AXIS)
        want = step(jax.device_put(state, NamedSharding(mesh, P())), put)
    return {k: np.asarray(want[k]) for k in ("valid", "scores", "boxes", "level_idx")}


def write_jax_case(work):
    """JAX's FCOS model, weights and batch; the weights and the batch
    written for the ranks."""
    model = JFCOSOverNeRF(backbone_type="resnet_tiny", resolution=32, num_convs=1)
    params, stats = jax_variables(model, cases.FCOS_JAX_SHAPE, seed=2)
    port = FCOSOverNeRF("resnet_tiny", num_convs=1, resolution=32)
    torch.save(weights.from_jax_params(params, stats, port.backbone),
               f"{work}/fcos_weights.pt")
    grids = base.grids(cases.FCOS_JAX_SHAPE, seed=4).numpy().astype(np.float32)
    batch = {"grids": grids, "ori_sizes": np.array([[32, 32, 32], [30, 32, 28]], np.int32)}
    torch.save({k: torch.from_numpy(v) for k, v in batch.items()}, f"{work}/fcos_batch.pt")
    return model, params, stats, batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results by (case, layout) and the one process's by case;
    the ranks' gradchecks; the ranks' evals of JAX's weights and JAX's."""
    work = tmp_path_factory.mktemp("space_fcos")
    jmodel, params, stats, batch = write_jax_case(work)
    join = base.launch_in_background(work, cases.fcos_ranks, n_ranks=(2, 4))
    threads = torch.get_num_threads()
    torch.set_num_threads(base.THREADS)
    try:  # the references, while the ranks run
        alone = {name: cases.run_fcos(name) for name in cases.FCOS_CASES}
        step = jax_eval_step(jmodel, JFCOSConfig(**cases.FCOS_JAX_CFG), cases.FCOS_JAX_SHAPE)
        jax_out = jax_space_eval(step, params, stats, batch)
    finally:
        torch.set_num_threads(threads)
        join()

    def load(tag, r):
        return torch.load(f"{work}/{tag}_rank{r}.pt", weights_only=False)

    ranks = {(name, "1x2"): [load(name, r) for r in (0, 1)] for name in cases.FCOS_CASES}
    ranks[cases.FCOS_2X2, "2x2"] = [load(f"{cases.FCOS_2X2}_2x2", r) for r in range(4)]
    checks = [torch.load(f"{work}/gradchecks_rank{r}.pt") for r in (0, 1)]
    evals = [torch.load(f"{work}/fcos_eval_rank{r}.pt", weights_only=False) for r in (0, 1)]
    return ranks, alone, checks, evals, jax_out


def _scenes(t, layout, rank):
    """The one process's scenes that a rank of ``layout`` holds."""
    if layout == "1x2":
        return t
    d = rank // 2
    return t[d:d + 1]


@pytest.mark.parametrize("name,layout,rank", LAYOUTS)
def test_eval_head_outputs_are_the_one_process(runs, name, layout, rank):
    got, want = runs[0][name, layout][rank]["heads"], runs[1][name]["heads"]
    for g, w in zip(got[:3], want[:3]):
        w = _scenes(w, layout, rank)
        assert g.shape == w.shape
        assert base.rel(g, w) <= 1e-10, base.rel(g, w)
    for g, w in zip(got[3], want[3]):  # the voxel scores, a level each
        assert base.rel(g, _scenes(w, layout, rank)) <= 1e-10


@pytest.mark.parametrize("name,layout,rank", LAYOUTS)
def test_eval_proposals_are_the_one_process(runs, name, layout, rank):
    got = runs[0][name, layout][rank]["proposals"]
    want = {k: _scenes(v, layout, rank) for k, v in runs[1][name]["proposals"].items()
            if k != "voxel_scores"}
    assert torch.equal(got["valid"], want["valid"]) and want["valid"].sum() > 20
    assert torch.equal(got["level_idx"], want["level_idx"])
    assert torch.equal(got["valid"].sum(1), want["valid"].sum(1))
    for k in ("boxes", "scores"):
        assert base.rel(got[k], want[k]) <= 1e-10, (k, base.rel(got[k], want[k]))


@pytest.mark.parametrize("name,layout", sorted({(n, lay) for n, lay, _ in LAYOUTS}))
def test_train_loss_terms_and_norms(runs, name, layout):
    want = runs[1][name]["metrics"]
    assert want["loss"] > 0 and want["dropped_positives"] == 0
    for got in runs[0][name, layout]:
        assert set(got["metrics"]) == set(want)
        for k, w in want.items():
            assert abs(got["metrics"][k] - w) <= 1e-10 * abs(w), (k, got["metrics"][k], w)


@pytest.mark.parametrize("name,layout", sorted({(n, lay) for n, lay, _ in LAYOUTS}))
def test_train_gradients_sum_to_the_one_process(runs, name, layout):
    want = runs[1][name]["grads"]
    got = runs[0][name, layout][0]["grads"]
    assert set(got) == set(want)
    top = max(w.abs().max().item() for w in want.values())
    for n, w in want.items():
        assert base.grad_rel(got[n], w, top) <= 1e-10, (n, base.grad_rel(got[n], w, top))


@pytest.mark.parametrize("name,layout", sorted({(n, lay) for n, lay, _ in LAYOUTS}))
def test_train_updated_weights_and_running_statistics(runs, name, layout):
    want = runs[1][name]["state"]
    got = runs[0][name, layout][0]["state"]
    assert any("running_" in k for k in want) == ("resnet" in name)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], w), k
        else:
            err = base.rel(got[k], w, 1e-30 if "running_" in k else 1.0)
            assert err <= 1e-10, (k, err)


@pytest.mark.parametrize("name,layout", sorted({(n, lay) for n, lay, _ in LAYOUTS}))
def test_ranks_are_bit_equal_after_the_step(runs, name, layout):
    assert all(r["ranks_equal"] for r in runs[0][name, layout])


@pytest.mark.parametrize("kind", cases.GRADCHECKS)
@pytest.mark.parametrize("rank", (0, 1))
def test_all_reduce_and_group_norm_gradcheck(runs, kind, rank):
    assert runs[2][rank][kind] is True, runs[2][rank][kind]


def _matched(got, want, score_tol, box_tol):
    """Whether every kept proposal of ``want`` has one of ``got``'s, each
    matched once: the same level, the score within ``score_tol``, the box
    within ``box_tol``.  FCOS's scores of random weights sit within 1e-6 of
    each other by the dozen, so two implementations order such rows
    differently."""
    for b in range(want["valid"].shape[0]):
        wv, gv = want["valid"][b], got["valid"][b]
        ws, wb, wl = (np.asarray(want[k][b])[wv] for k in ("scores", "boxes", "level_idx"))
        gs, gb, gl = (np.asarray(got[k][b])[gv] for k in ("scores", "boxes", "level_idx"))
        free = np.ones(len(gs), bool)
        for s, box, lvl in zip(ws, wb, wl):
            ok = free & (gl == lvl) & (np.abs(gs - s) <= score_tol) & (
                np.abs(gb - box).max(axis=1) <= box_tol)
            if not ok.any():
                return False
            free[np.flatnonzero(ok)[0]] = False
    return True


@pytest.mark.parametrize("rank", (0, 1))
def test_resnet_tiny_fcos_eval_matches_jax_space_path(runs, rank):
    got = {k: v.numpy() for k, v in runs[3][rank].items() if k != "voxel_scores"}
    want = runs[4]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["valid"].sum(1), want["valid"].sum(1))
    assert want["valid"].sum() > 10
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)
    assert _matched(got, want, 1e-5, 1e-4)
