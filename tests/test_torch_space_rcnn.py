"""The ``space`` axis on the RCNN second stage: ``make_rcnn_eval_step`` /
``make_rcnn_train_step(..., space=groups)``.

Spawned gloo ranks (a ``file://`` rendezvous in the test's temporary
directory) run each case of ``torch_space_rcnn_cases.py`` -- ``--fine_tune``
on ``resnet_tiny`` at 32^3 (the backbone on the rank's slab, each FPN level
gathered) and the features mode (the levels whole on every rank) -- on
their parts of the global batch (``space.shard_batch``) at ``(n_data,
n_space) = (1, 2)``, then at ``(2, 2)``; the port's one process runs the
same steps on the whole batch meanwhile.  In f64:

- eval: every RoI's scores, refined boxes, labels and validity within
  1e-10 (relative) of the one process's scenes that the rank's data group
  holds (labels and validity equal);
- train: the loss terms, the fg / bg counts, ``grad_norm`` and
  ``param_norm`` within 1e-10 (relative; the counts equal), the ranks'
  gradients summed over the world within 1e-10 of each leaf's largest
  entry (``torch_space_cases.grad_rel``), the updated parameters (to
  max(1, the leaf's largest)) and the running statistics within 1e-10, and
  the ranks' weights after the step bit-equal.  Each rank of a space group
  pools, scores and takes the losses of its own block of each scene's
  sampled RoIs (``space.row_block``), the normalisers summed over the
  world.

The same ranks run ``torch.autograd.gradcheck`` (f64) of the gather whose
backward sums the gradient over the space group (``gather_x(...,
sum_grad=True)``; also with one rank's slab empty), between a scatter of a
global input and a gather of each rank's own part of a function of the
gathered rows.  And they show the trap the row split avoids: every rank
of a space group running the head on all the sampled RoIs (the gather's
backward keeping the rank's own rows, the RPN's rule) sums to a head
gradient of exactly ``n_space`` times the one process's over the world.

Last, the port's RCNN eval of JAX's weights (``--fine_tune`` on
``resnet_tiny`` at 32^3, the conv tower, max pooling) on two scenes: JAX's
own ``make_rcnn_eval_step`` under ``make_mesh_2d(1, 2)`` with the grids
put by ``grid_sharding`` (the conftest gives 8 CPU devices), the port on
its two ranks with the weights carried by ``weights.rcnn_from_jax_params``,
in f32.  On each rank: ``valid`` and the labels equal, scores within 1e-5
and boxes within 1e-4 (absolute).  Only the eval runs on the JAX side: a
train step's jit would add its compile time to the suite.
"""

import jax
import numpy as np
import pytest
import torch
import torch_space_cases as base
import torch_space_rcnn_cases as cases
from jax.sharding import NamedSharding, PartitionSpec as P

from nerf_rpn_tpu.models import detector as jdet
from nerf_rpn_tpu.models.nerf_rpn import build_backbone as jbuild
from nerf_rpn_tpu.parallel.mesh import DATA_AXIS, SPACE_AXIS, grid_sharding, make_mesh_2d
from nerf_rpn_tpu.train.state import TrainState as JTrainState
from nerf_rpn_tpu.train.steps import make_rcnn_eval_step as jax_eval_step
from nerf_rpn_tpu_torch import weights
from nerf_rpn_tpu_torch.models.nerf_rpn import build_backbone

RUNS = [(name, layout) for name in cases.CASES for layout in cases.LAYOUTS]
RANKS = [(name, "1x2", r) for name in cases.CASES for r in (0, 1)] + \
    [(name, "2x2", r) for name in cases.CASES for r in range(4)]


def jax_variables(shape, seed):
    """JAX's RCNN variables in the shapes of ``init`` (``jax.eval_shape``),
    drawn from numpy: kernels N(0, 1 / fan_in), biases, scales and running
    statistics near their starting values (f32)."""
    head = jdet.RCNNHead(**cases.JAX_HEAD)
    backbone = jbuild("resnet_tiny", shape[0])
    hv = jax.eval_shape(lambda k: head.init(k, jax.numpy.zeros((1, 2, 2, 2, 32))),
                        jax.random.PRNGKey(0))
    bv = jax.eval_shape(lambda k: backbone.init(k, jax.numpy.zeros((1, *shape, 4))),
                        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if name.endswith("kernel"):
            return (np.prod(leaf.shape[:-1]) ** -0.5
                    * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name.endswith("var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        start = 1.0 if name.endswith("scale") else 0.0
        return (start + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    draw_tree = lambda t: jax.tree_util.tree_map_with_path(draw, t)
    params = {"backbone": draw_tree(bv["params"]), "head": draw_tree(hv["params"])}
    return head, backbone, params, draw_tree(bv["batch_stats"])


def write_jax_case(work):
    """JAX's RCNN, weights and batch; the weights and the batch written for
    the ranks."""
    head, backbone, params, stats = jax_variables(cases.SHAPE, seed=3)
    port_backbone = build_backbone("resnet_tiny", cases.SHAPE[0])
    torch.save(weights.rcnn_from_jax_params(params, stats, port_backbone),
               f"{work}/rcnn_weights.pt")
    batch = {k: v.numpy() for k, v in cases.rois(np.random.default_rng(8), False).items()}
    batch = {k: v.astype(np.float32) if v.dtype == np.float64 else
             v.astype(np.int32) if v.dtype == np.int64 else v for k, v in batch.items()}
    batch["grids"] = base.grids(cases.SHAPE, seed=4).numpy().astype(np.float32)
    torch.save({k: torch.from_numpy(v) for k, v in batch.items()}, f"{work}/rcnn_batch.pt")
    return head, backbone, params, stats, batch


def jax_space_eval(head, backbone, params, stats, batch):
    """JAX's RCNN eval under ``make_mesh_2d(1, 2)``, the grids x-sharded by
    ``grid_sharding``."""
    step = jax_eval_step(head, jdet.RCNNConfig(**cases.JAX_CFG), cases.SCALES, backbone)
    state = JTrainState(step=0, params=params, batch_stats=stats, opt_state=None, tx=None)
    mesh = make_mesh_2d(1, 2)
    with mesh:
        put = {k: jax.device_put(v, grid_sharding(mesh) if v.ndim == 5 else
                                 NamedSharding(mesh, P(DATA_AXIS)))
               for k, v in batch.items()}
        assert put["grids"].sharding.spec == P(DATA_AXIS, SPACE_AXIS)
        want = step(jax.device_put(state, NamedSharding(mesh, P())), put)
    return {k: np.asarray(v) for k, v in want.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results by (case, layout) and the one process's by case;
    the ranks' gradchecks and head gradients without the row split, the one
    process's; the ranks' evals of JAX's weights and JAX's."""
    work = tmp_path_factory.mktemp("space_rcnn")
    jax_case = write_jax_case(work)
    join = base.launch_in_background(work, cases.rcnn_ranks, n_ranks=(2, 4))
    threads = torch.get_num_threads()
    torch.set_num_threads(base.THREADS)
    try:  # the references, while the ranks run
        alone = {name: cases.run_rcnn(name) for name in cases.CASES}
        no_split_alone = cases.head_grads_without_row_split()
        jax_out = jax_space_eval(*jax_case)
    finally:
        torch.set_num_threads(threads)
        join()

    def load(tag, r):
        return torch.load(f"{work}/{tag}_rank{r}.pt", weights_only=False)

    ranks = {(name, layout): [load(f"{name}_{layout}", r)
                              for r in range(2 if layout == "1x2" else 4)]
             for name, layout in RUNS}
    checks = [load("gradchecks", r) for r in (0, 1)]
    no_split = [load("no_split", r) for r in (0, 1)]
    evals = [load("rcnn_eval", r) for r in (0, 1)]
    return ranks, alone, checks, (no_split, no_split_alone), evals, jax_out


def _scenes(t, layout, rank):
    """The one process's scenes that a rank of ``layout`` holds."""
    if layout == "1x2":
        return t
    d = rank // 2
    return t[d:d + 1]


@pytest.mark.parametrize("name,layout,rank", RANKS)
def test_eval_scores_every_roi_as_the_one_process(runs, name, layout, rank):
    got = runs[0][name, layout][rank]["eval"]
    want = {k: _scenes(v, layout, rank) for k, v in runs[1][name]["eval"].items()}
    assert set(got) == set(want)
    for k in ("labels", "valid"):
        assert torch.equal(got[k], want[k]), k
    assert want["labels"].sum() > 0
    for k in ("scores", "refined_boxes"):
        assert got[k].shape == want[k].shape
        assert base.rel(got[k], want[k]) <= 1e-10, (k, base.rel(got[k], want[k]))


@pytest.mark.parametrize("name,layout", RUNS)
def test_train_loss_terms_counts_and_norms(runs, name, layout):
    want = runs[1][name]["metrics"]
    assert want["loss_rpn_box_reg"] > 0 and 0 < want["fg_rois"] < 2 * cases.K
    assert want["fg_rois"] + want["bg_rois"] == 2 * cases.K
    for got in runs[0][name, layout]:
        assert set(got["metrics"]) == set(want)
        for k, w in want.items():
            if k.endswith("_rois"):
                assert got["metrics"][k] == w, k
            else:
                assert abs(got["metrics"][k] - w) <= 1e-10 * abs(w), (k, got["metrics"][k], w)


@pytest.mark.parametrize("name,layout", RUNS)
def test_train_gradients_sum_to_the_one_process(runs, name, layout):
    want = runs[1][name]["grads"]
    got = runs[0][name, layout][0]["grads"]
    assert set(got) == set(want)
    assert any(n.startswith("backbone.") for n in got) == name.startswith("finetune")
    top = max(w.abs().max().item() for w in want.values())
    for n, w in want.items():
        assert base.grad_rel(got[n], w, top) <= 1e-10, (n, base.grad_rel(got[n], w, top))


@pytest.mark.parametrize("name,layout", RUNS)
def test_train_updated_weights_and_running_statistics(runs, name, layout):
    want = runs[1][name]["state"]
    got = runs[0][name, layout][0]["state"]
    assert any("running_" in k for k in want) == name.startswith("finetune")
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], w), k
        else:
            err = base.rel(got[k], w, 1e-30 if "running_" in k else 1.0)
            assert err <= 1e-10, (k, err)


@pytest.mark.parametrize("name,layout", RUNS)
def test_ranks_are_bit_equal_after_the_step(runs, name, layout):
    assert all(r["ranks_equal"] for r in runs[0][name, layout])


@pytest.mark.parametrize("kind", cases.GRADCHECKS)
@pytest.mark.parametrize("rank", (0, 1))
def test_summed_gather_gradcheck(runs, kind, rank):
    assert runs[2][rank][kind] is True, runs[2][rank][kind]


@pytest.mark.parametrize("rank", (0, 1))
def test_head_gradient_without_the_row_split_is_n_space_times(runs, rank):
    """Every rank of the space group scoring all the RoIs counts the head's
    gradient twice over the world; the step's row split counts it once."""
    got, alone = runs[3][0][rank], runs[3][1]
    split = runs[0]["finetune_resnet_tiny_aabb_32", "1x2"][rank]["grads"]
    for n, w in alone.items():
        assert w.abs().max() > 0, n
        assert base.rel(got[n], 2 * w) <= 1e-10, (n, base.rel(got[n], 2 * w))
        assert base.rel(split[f"head.{n}"], w) <= 1e-10, n


@pytest.mark.parametrize("rank", (0, 1))
def test_resnet_tiny_rcnn_eval_matches_jax_space_path(runs, rank):
    got = {k: v.numpy() for k, v in runs[4][rank].items()}
    want = runs[5]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert want["labels"].sum() > 0
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["refined_boxes"], want["refined_boxes"], rtol=0, atol=1e-4)
