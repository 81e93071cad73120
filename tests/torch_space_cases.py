"""Cases and rank code of the ``space``-axis tests (``test_torch_space_*.py``).

The cases run the anchor RPN's eval and train steps through
``make_rpn_eval_step`` / ``make_rpn_train_step`` in f64, in one process on
a global batch of two unlike scenes or, with ``groups``, on a rank's part
of it (``space.shard_batch``):

- ``swin_aabb_64``: a narrow Swin (embed 16, two blocks a stage, so that
  shifted blocks occur) at 64 x 8 x 24, AABB -- stages 2 and 3 have one
  window column, so the second rank of a space group holds no rows there;
- ``swin_obb_66``: the same Swin at 66 x 8 x 24, OBB -- 33 voxels a rank,
  XLA's SAME pad puts a row before x = 0, the 17 tokens of stage 0 go over
  5 window columns (3/2), so rows move to window-aligned slabs, and patch
  merging meets 17, 9 and 5 rows;
- ``resnet_tiny_aabb_32``: ``resnet_tiny`` at 32 x 40 x 40, AABB, train-mode
  BatchNorm -- its last level is one row, none on the second rank.

Also here: the exchanges' gradchecks and the rank side of the comparison
with JAX's space path.  The module imports no JAX, so that spawned ranks
start quickly; the ranks run in a thread's ``ddp.launch`` while the test
process computes its references (:func:`launch_in_background`).
"""

import dataclasses
import threading

import numpy as np
import torch
import torch.distributed as dist

from nerf_rpn_tpu_torch.models import rpn
from nerf_rpn_tpu_torch.models.heads import RPNHead3D
from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN, init_params
from nerf_rpn_tpu_torch.models.swin import SwinBlock, SwinFPN
from nerf_rpn_tpu_torch.parallel import ddp
from nerf_rpn_tpu_torch.parallel import space as sp
from nerf_rpn_tpu_torch.train.state import TrainState
from nerf_rpn_tpu_torch.train.steps import (level_shapes_for, make_rpn_eval_step,
                                               make_rpn_train_step)

F64 = torch.float64
CPU = torch.device("cpu")
STRIDES = (4, 8, 16, 32)
LR, TOTAL = 1e-3, 10
CASES = {
    "swin_aabb_64": dict(backbone="swin", shape=(64, 8, 24), rotated=False),
    "swin_obb_66": dict(backbone="swin", shape=(66, 8, 24), rotated=True),
    "resnet_tiny_aabb_32": dict(backbone="resnet_tiny", shape=(32, 40, 40), rotated=False),
}
EXCHANGES = ("halo", "wrapped", "to_empty", "from_empty", "gather")
# the CPU threads of every process of the comparisons (the ranks and the one
# process): one.  Under the test suite's load some processes' second
# OpenMP thread computed the Swin window attention's f64 twin ~3e-10 off
# (relative) on its half of the windows, the first thread's half exact,
# against an extended-precision reference -- a process-wide state, not
# rounding order (one or two threads otherwise agree within 1e-15)
THREADS = 1


# ---------------------------------------------------------------------------
# The cases: a model, a global batch, and the step's seeds
# ---------------------------------------------------------------------------


def grids(shape, b=2, seed=0):
    """Unlike scenes: noise, then a ramp along x with a dense block (the
    ``resnet_tiny`` BatchNorms of a deep level see few values; unlike
    scenes keep their variance clear of rounding)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0, 1, (b, *shape, 4))
    x = shape[0]
    g[1] = 0.1 * g[1] + 3.0 * np.linspace(0, 1, x)[:, None, None, None] ** 2
    g[1, x // 8:x * 5 // 8, 2:shape[1] - 2, 3:shape[2] - 2, 3] += 4.0
    g[1, ..., 1] *= -1
    return torch.from_numpy(g)


def gt_boxes(shape, rotated):
    x, y, z = shape
    if rotated:
        gt = [[[0.3 * x, 0.4 * y, 0.5 * z, 0.3 * x, 0.5 * y, 0.4 * z, 0.4],
               [0.7 * x, 0.6 * y, 0.4 * z, 0.25 * x, 0.4 * y, 0.5 * z, -1.1]],
              [[0.5 * x, 0.5 * y, 0.5 * z, 0.6 * x, 0.6 * y, 0.5 * z, 0.8],
               [0, 0, 0, 0, 0, 0, 0]]]
    else:
        gt = [[[2, 1, 2, 0.45 * x, 0.7 * y, 0.6 * z], [0.5 * x, 0.3 * y, 0.4 * z, 0.95 * x, y, z]],
              [[0.1 * x, 0.2 * y, 0.1 * z, 0.7 * x, 0.8 * y, 0.9 * z], [0, 0, 0, 0, 0, 0]]]
    gt = torch.tensor(gt, dtype=F64)
    return gt, gt[..., 3] > 0


def narrow_swin_rpn(rotated, dtype=F64):
    """The anchor RPN on a narrow Swin: embed 16, two blocks a stage,
    16-channel levels, a one-conv head."""
    model = NeRFRPN("swin_t", conv_depth=1, rotated=rotated, dtype=dtype)
    model.backbone = SwinFPN(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4),
                             out_channels=16, dtype=dtype)
    model.rpn_head = RPNHead3D(16, 13, 1, rotated, dtype)
    return model


def randomise_running_stats(model):
    """Running statistics that are not 0 / 1, drawn from seed 3."""
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for n, t in model.named_buffers():
            if "running_" in n:
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))


def setup(name, drop_path=True, spec=None):
    """``(model, cfg, batch)`` of a case (``spec``: a case's entry, default
    ``CASES[name]``; ``resolution`` sets the backbone's ``input_size``),
    the same in every process."""
    spec = spec or CASES[name]
    shape, rotated = spec["shape"], spec["rotated"]
    if spec["backbone"] == "swin":
        model = narrow_swin_rpn(rotated)
    else:
        model = NeRFRPN(spec["backbone"], conv_depth=1, rotated=rotated, dtype=F64,
                        resolution=spec.get("resolution", shape[0]))
    init_params(model, torch.Generator().manual_seed(1))
    model.to(F64)
    randomise_running_stats(model)
    with torch.no_grad():
        model.rpn_head.cls_logits.weight.mul_(0.05)  # moderate head outputs
        model.rpn_head.bbox_pred.weight.mul_(0.05)
    if not drop_path:
        for m in model.modules():
            if isinstance(m, SwinBlock):
                m.drop_path = 0.0
    cfg = rpn.RPNConfig(rotated=rotated, reg_loss_weight=5.0, reg_loss_weight_2d=0.5,
                        reg_loss_type="iou" if rotated else "smooth_l1",
                        pre_nms_top_n=300, post_nms_top_n=100)
    gt, mask = gt_boxes(shape, rotated)
    batch = {"grids": grids(shape), "gt_boxes": gt, "gt_mask": mask,
             "ori_sizes": torch.tensor([shape, [shape[0] - 2, *shape[1:]]], dtype=torch.int32)}
    return model, cfg, batch


def sample(cfg, batch, shape):
    """The anchor sample of the whole batch, drawn from seed 0."""
    shapes = level_shapes_for(shape, STRIDES)
    anchors, _, strides, _ = rpn.build_level_tables(cfg, shape, shapes)
    pad = rpn.dynamic_padding_masks(shapes, strides, 13, batch["ori_sizes"])
    matches = rpn.assign_anchors(cfg, torch.from_numpy(anchors).to(F64), batch["gt_boxes"],
                                 batch["gt_mask"], pad)
    return list(rpn.sample_anchors(cfg, matches, torch.Generator().manual_seed(0)))


def run_case(name, groups=None, indices=None, drop_path=True, spec=None):
    """A case's eval (head outputs and proposals), then its train step:
    the metrics, the trained parameters' gradients before any sum over the
    ranks, and the weights after the update."""
    model, cfg, batch = setup(name, drop_path, spec)
    shape = (spec or CASES[name])["shape"]
    part = batch if groups is None else sp.shard_batch(batch, groups)
    step = make_rpn_eval_step(model, cfg, shape, space=groups)
    _, obj, dl, _ = step.forward(part["grids"])
    proposals = step(part["grids"], part["ori_sizes"])
    state = TrainState(model, LR, TOTAL)
    grads, apply = {}, state.apply_gradients

    def capture():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        return apply()

    state.apply_gradients = capture
    train = make_rpn_train_step(model, cfg, shape, space=groups)
    metrics = train(state, part, torch.Generator().manual_seed(0),
                    torch.Generator().manual_seed(1), indices=indices)
    return {"obj": obj, "dl": dl, "proposals": proposals,
            "metrics": {k: v.item() for k, v in metrics.items()}, "grads": grads,
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def rank_results(work, tag, out):
    """Sums the gradients over the world, checks the ranks' weights after
    the step against rank 0's bit for bit, and writes the rank's results."""
    for g in out["grads"].values():
        dist.all_reduce(g)
    mine = torch.cat([t.reshape(-1).double() for t in out["state"].values()])
    rank0 = mine.clone()
    dist.broadcast(rank0, 0)
    out["ranks_equal"] = torch.equal(mine, rank0)
    torch.save(out, f"{work}/{tag}_rank{ddp.rank()}.pt")


# ---------------------------------------------------------------------------
# The exchanges' gradchecks
# ---------------------------------------------------------------------------


class _Scatter(torch.autograd.Function):
    """A global tensor -> this rank's slab; the backward sums every rank's
    slab gradient into the global one, so each rank sees the gradient of
    the whole function."""

    @staticmethod
    def forward(ctx, x, slab):
        ctx.slab = slab
        return x[:, slab.lo:slab.hi].clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros((g.shape[0], ctx.slab.extent, *g.shape[2:]))
        full[:, ctx.slab.lo:ctx.slab.hi] = g
        dist.all_reduce(full, group=ctx.slab.groups.space_group)
        return full, None


def _exchange(kind, groups):
    """``(fn, extent)``: a global input of ``extent`` rows -> the gathered
    outputs of an exchange."""
    def slab(bounds, extent):
        return sp.Slab(groups, bounds, extent)

    src = slab(((0, 3), (3, 5)), 5)
    if kind == "halo":
        out = slab(((0, 5), (5, 9)), 9)  # a row each side: 3 + 2, 2 + 2

        def fn(x):
            return sp.halo_x(x, src, 1, 1)
    elif kind == "wrapped":  # a cyclic shift by 2 along x
        out = slab(((0, 3), (3, 5)), 5)

        def fn(x):
            return sp.reshard_x(x, src, [[(j + 2) % 5 for j in range(a, b)]
                                         for a, b in src.bounds])
    elif kind == "to_empty":  # everything to rank 0, and a pad row
        out = slab(((0, 6), (6, 6)), 6)

        def fn(x):
            return sp.reshard_x(x, src, [list(range(5)) + [-1], []])
    elif kind == "from_empty":
        src = slab(((0, 5), (5, 5)), 5)
        out = slab(((0, 2), (2, 5)), 5)

        def fn(x):
            return sp.reshard_x(x, src, [[4, 4], [0, 1, 2]])
    else:
        out = src

        def fn(x):
            return x
    return (lambda xg: sp.gather_x(fn(_Scatter.apply(xg, src)), out)), src.extent


def gradchecks(groups):
    ok = {}
    for kind in EXCHANGES:
        fn, extent = _exchange(kind, groups)
        x = torch.randn((1, extent, 2, 1, 2), dtype=F64,
                        generator=torch.Generator().manual_seed(5), requires_grad=True)
        try:
            ok[kind] = torch.autograd.gradcheck(fn, (x,))
        except Exception as e:  # recorded, asserted in the main process
            ok[kind] = repr(e)
    return ok


# the model of the comparison with JAX, ``tests/test_multidevice.py``'s:
# ``resnet_tiny`` at 32^3, ``conv_depth`` 1, one anchor a level (of four)
ONE_ANCHOR_SHAPE = (32, 32, 32)
ONE_ANCHOR_SIZES = ((8.0,), (16.0,), (24.0,), (32.0,))
ONE_ANCHOR_RATIOS = (((1.0, 1.0, 1.0),),) * 4
ONE_ANCHOR_NMS = dict(pre_nms_top_n=64, post_nms_top_n=32)


@dataclasses.dataclass(frozen=True)
class OneAnchorConfig(rpn.RPNConfig):
    anchor_sizes = ONE_ANCHOR_SIZES
    aspect_ratios = ONE_ANCHOR_RATIOS


def one_anchor_eval(work, groups):
    """The eval step of JAX's model on this rank's slab of the batch in
    ``work``, with the weights there (f32)."""
    model = NeRFRPN("resnet_tiny", conv_depth=1, num_anchors=1, resolution=32)
    model.load_state_dict(torch.load(f"{work}/weights.pt"), strict=True)
    part = sp.shard_batch(torch.load(f"{work}/batch.pt"), groups)
    step = make_rpn_eval_step(model, OneAnchorConfig(**ONE_ANCHOR_NMS),
                              ONE_ANCHOR_SHAPE, space=groups)
    torch.save(step(part["grids"], part["ori_sizes"]), f"{work}/eval_rank{ddp.rank()}.pt")


def ranks_1x2(work):
    """A rank of ``test_torch_space_steps.py``: every case on its slab,
    the gradchecks, and the eval of JAX's model on its slab."""
    torch.set_num_threads(THREADS)
    groups = ddp.space_groups()
    for name in CASES:
        rank_results(work, name, run_case(name, groups))
    torch.save(gradchecks(groups), f"{work}/gradchecks_rank{ddp.rank()}.pt")
    one_anchor_eval(work, groups)


def launch_in_background(work, fn, n_ranks=(2,)):
    """Starts ``fn(work)`` on CPU ranks in space groups of two (gloo, a
    ``file://`` rendezvous in ``work``) in a thread, once for each count of
    ``n_ranks``, one launch after another; returns a ``join()`` that waits
    for them and raises what a rank raised."""
    error = []

    def run():
        try:
            for n in n_ranks:
                ddp.launch(fn, (str(work),), [CPU] * n, "gloo",
                           init_method=f"file://{work}/rendezvous{n}", n_space=2)
        except BaseException as e:  # noqa: BLE001 - re-raised by join()
            error.append(e)

    thread = threading.Thread(target=run)
    thread.start()

    def join():
        thread.join()
        if error:
            raise error[0]

    return join


def rel(got, want, floor=1e-30):
    """The largest difference over ``want``'s largest entry (or ``floor``)."""
    return (got - want).abs().max().item() / max(want.abs().max().item(), floor)


def grad_rel(got, want, top):
    """:func:`rel` of a gradient leaf, where ``top`` is the model's largest
    gradient entry.  A leaf whose gradient is zero in exact arithmetic -- a
    conv's bias before a norm that removes any constant of a channel -- holds
    rounding (~1e-17): a leaf whose largest entry is below 1e-12 of ``top``
    is taken relative to ``top``."""
    return rel(got, want, top if want.abs().max().item() < 1e-12 * top else 1e-30)
