"""Cases and rank code of the RCNN ``space``-axis test
(``test_torch_space_rcnn.py``).

The cases run ``make_rcnn_eval_step`` / ``make_rcnn_train_step`` in f64,
in one process on a global batch of two scenes or, with ``groups``, on a
rank's part of it (``space.shard_batch``):

- ``finetune_resnet_tiny_aabb_32``: ``--fine_tune`` on ``resnet_tiny`` at
  32^3 (the unlike scenes of ``torch_space_cases.grids``; train-mode
  BatchNorm, whose last level is one row, none on the second rank of a
  space group), AABB RoIs, max pooling, the conv tower;
- ``features_obb``: the features mode, random f64 levels (8^3 ... 1^3, 16
  channels), OBB RoIs, align, flatten.

Each samples ``K`` RoIs a scene.  At ``(n_data, n_space) = (1, 2)`` the
ranks draw the sample from the one process's seed (a space group draws
alike); at ``(2, 2)`` they take the one process's sample (``indices``), as
the data groups draw streams of their own.

Also here: the gradchecks of ``space.gather_x(..., sum_grad=True)``; the
trap that the row split avoids -- every rank of a space group running the
head on all the sampled RoIs, whose world-summed head gradient is then
``n_space`` times the one process's; and the rank side of the comparison
with JAX's RCNN eval under ``make_mesh_2d(1, 2)``.  The module imports no
JAX, so that spawned ranks start quickly.
"""

import numpy as np
import torch

import torch_space_cases as base
from nerf_rpn_tpu_torch.models import detector as det
from nerf_rpn_tpu_torch.models.nerf_rpn import build_backbone, init_params
from nerf_rpn_tpu_torch.parallel import ddp
from nerf_rpn_tpu_torch.parallel import space as sp
from nerf_rpn_tpu_torch.train.state import TrainState
from nerf_rpn_tpu_torch.train.steps import (make_rcnn_eval_step, make_rcnn_train_step,
                                               rcnn_pool)

F64 = base.F64
SCALES = (4, 8, 16, 32)
K = 16             # sampled RoIs a scene
REG_W = 5.0        # the driver's --reg_loss_weight
SHAPE = (32, 32, 32)
CASES = {
    # (fine_tune, rotated, pool mode, conv tower, flatten, channels)
    "finetune_resnet_tiny_aabb_32": (True, False, "max", True, True, 32),
    "features_obb": (False, True, "avg", False, True, 16),
}
LAYOUTS = ("1x2", "2x2")
GRADCHECKS = ("gather_sum", "gather_sum_empty")


def rois(rng, rotated, b=2, r=40):
    """Per scene: jittered copies of its gt boxes (foreground) and random
    boxes, AABBs or OBBs in a 32^3 grid; the gt boxes, their mask and the
    RoIs' levels and validity."""
    if rotated:
        gt = np.concatenate([rng.uniform(8, 24, (b, 2, 3)), rng.uniform(5, 10, (b, 2, 3)),
                             rng.uniform(-1.5, 1.5, (b, 2, 1))], -1)
        box = np.concatenate([rng.uniform(2, 30, (b, r, 3)), rng.uniform(2, 10, (b, r, 3)),
                              rng.uniform(-1.5, 1.5, (b, r, 1))], -1)
    else:
        lo = rng.uniform(2, 18, (b, 2, 3))
        gt = np.concatenate([lo, lo + rng.uniform(5, 12, (b, 2, 3))], -1)
        lo = rng.uniform(0, 26, (b, r, 3))
        box = np.concatenate([lo, lo + rng.uniform(2, 10, (b, r, 3))], -1)
    box[:, :8] = np.repeat(gt, 4, 1) + rng.uniform(-0.8, 0.8, (b, 8, gt.shape[-1]))
    valid = np.ones((b, r), bool)
    valid[1, -5:] = False
    return {"rois": torch.from_numpy(box), "gt_boxes": torch.from_numpy(gt),
            "gt_mask": torch.ones((b, 2), dtype=torch.bool),
            "roi_levels": torch.from_numpy(rng.integers(0, 4, (b, r))),
            "roi_valid": torch.from_numpy(valid)}


def setup(name):
    """``(model, cfg, batch)`` of a case, the same in every process."""
    fine_tune, rotated, pool, add, flatten, c = CASES[name]
    cfg = det.RCNNConfig(rotated=rotated, output_size=(2, 2, 2), pool_mode=pool,
                         fg_threshold=0.3, bg_threshold=0.25)
    head = det.RCNNHead(c, 2, rotated, add, flatten, (2, 2, 2), F64)
    model = det.RCNNDetector(head, build_backbone("resnet_tiny", SHAPE[0], F64)
                             if fine_tune else None)
    init_params(model, torch.Generator().manual_seed(1))
    model.to(F64)
    base.randomise_running_stats(model)
    rng = np.random.default_rng(7)
    batch = rois(rng, rotated)
    if fine_tune:
        batch["grids"] = base.grids(SHAPE)
    else:
        batch["features"] = [torch.from_numpy(rng.standard_normal((2, s, s, s, c)))
                             for s in (8, 4, 2, 1)]
    return model, cfg, batch


def sample(cfg, batch):
    """The one process's RoI sample of the whole batch, from seed 0."""
    return det.sample_rois(cfg, torch.Generator().manual_seed(0), batch["rois"],
                           batch["roi_levels"], batch["roi_valid"], batch["gt_boxes"],
                           batch["gt_mask"], K)["indices"]


def run_rcnn(name, groups=None, layout="1x2"):
    """A case's eval (every RoI scored), then its train step: the metrics,
    the gradients before any sum over the ranks, and the weights after the
    update."""
    model, cfg, batch = setup(name)
    part = batch if groups is None else sp.shard_batch(batch, groups)
    evaluated = make_rcnn_eval_step(model, cfg, SCALES, space=groups)(part)
    indices = None
    if layout == "2x2":
        indices = sample(cfg, batch)[groups.data_index:groups.data_index + 1]
    state = TrainState(model, base.LR, base.TOTAL)
    grads, apply = {}, state.apply_gradients

    def capture():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        return apply()

    state.apply_gradients = capture
    train = make_rcnn_train_step(model, cfg, SCALES, K, reg_loss_weight=REG_W, space=groups)
    metrics = train(state, part, torch.Generator().manual_seed(0), indices=indices)
    return {"eval": evaluated, "metrics": {k: v.item() for k, v in metrics.items()},
            "grads": grads, "state": {k: v.clone() for k, v in model.state_dict().items()}}


def head_grads_without_row_split(groups=None):
    """The fine-tune case's head gradients, summed over the world, where
    every rank of a space group pools and scores all the sampled RoIs from
    the gathered levels (whose backward keeps the rank's own rows) and
    divides by its data group's normalisers -- the rule of the RPN's and
    FCOS's steps, whose parameters all sit before the gather."""
    name = "finetune_resnet_tiny_aabb_32"
    model, cfg, batch = setup(name)
    model.train()
    if groups is None:
        feats = list(model.backbone(batch["grids"]))
    else:
        batch = sp.shard_batch(batch, groups)
        src = sp.input_slab(groups, SHAPE[0])
        feats = [sp.gather_x(f, sl) for f, sl in
                 zip(model.backbone(batch["grids"], None, src),
                     model.backbone.level_slabs(src))]
    s = det.sample_rois(cfg, torch.Generator().manual_seed(0), batch["rois"],
                        batch["roi_levels"], batch["roi_valid"], batch["gt_boxes"],
                        batch["gt_mask"], K)
    pooled = rcnn_pool(cfg, feats, s["boxes"], s["levels"], s["valid"], SCALES)
    deltas, scores = model.head(pooled.flatten(0, 1))
    d = cfg.box_dim
    losses = det.rcnn_losses(cfg, deltas, scores, s["labels"].reshape(-1),
                             s["matched_gt"].reshape(-1, d), s["boxes"].reshape(-1, d),
                             s["valid"].reshape(-1))
    (losses["loss_objectness"] + REG_W * losses["loss_rpn_box_reg"]).backward()
    grads = {n: p.grad.clone() for n, p in model.head.named_parameters()}
    ddp.all_reduce_grads_(list(grads.values()))
    return grads


# ---------------------------------------------------------------------------
# The gradchecks
# ---------------------------------------------------------------------------


def _gradcheck_fn(kind, groups):
    """A global input of 5 rows -> every rank's part of a function of the
    gathered slabs, gathered in turn so that every rank returns the whole
    function: rank r squares its own block of the gathered rows (blocks
    (0, 2), (2, 5), unlike the slabs), as the RCNN's ranks pool their own
    RoI blocks from the gathered levels."""
    bounds = ((0, 5), (5, 5)) if kind == "gather_sum_empty" else ((0, 3), (3, 5))
    slab = sp.Slab(groups, bounds, 5)
    parts = sp.Slab(groups, ((0, 2), (2, 5)), 5)

    def fn(xg):
        y = sp.gather_x(base._Scatter.apply(xg, slab), slab, sum_grad=True)
        mine = y[:, parts.lo:parts.hi]
        return sp.gather_x(mine * mine, parts)

    return fn


def gradchecks(groups):
    ok = {}
    for kind in GRADCHECKS:
        x = torch.randn((2, 5, 2, 1, 3), dtype=F64,
                        generator=torch.Generator().manual_seed(5), requires_grad=True)
        try:
            ok[kind] = torch.autograd.gradcheck(_gradcheck_fn(kind, groups), (x,))
        except Exception as e:  # recorded, asserted in the main process
            ok[kind] = repr(e)
    return ok


# ---------------------------------------------------------------------------
# The comparison with JAX: the port's side (f32)
# ---------------------------------------------------------------------------

# the model of the comparison: ``--fine_tune`` on ``resnet_tiny`` at 32^3,
# the conv tower, flatten, max pooling, AABB RoIs
JAX_CFG = dict(rotated=False, output_size=(2, 2, 2), pool_mode="max", fg_threshold=0.3,
               bg_threshold=0.25)
JAX_HEAD = dict(in_channels=32, rotated=False, add_conv_layers=True, flatten=True)


def jax_eval(work, groups):
    """The port's RCNN eval of JAX's weights on this rank's slab."""
    model = det.RCNNDetector(det.RCNNHead(32, 2, False, True, True, (2, 2, 2)),
                             build_backbone("resnet_tiny", SHAPE[0]))
    model.load_state_dict(torch.load(f"{work}/rcnn_weights.pt"), strict=True)
    part = sp.shard_batch(torch.load(f"{work}/rcnn_batch.pt"), groups)
    out = make_rcnn_eval_step(model, det.RCNNConfig(**JAX_CFG), SCALES, space=groups)(part)
    torch.save(out, f"{work}/rcnn_eval_rank{ddp.rank()}.pt")


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def rcnn_ranks(work):
    """A rank of ``test_torch_space_rcnn.py``: every case on its part of
    the batch; at (1, 2) also the gradchecks, the head gradients without
    the row split and the port's side of the comparison with JAX."""
    torch.set_num_threads(base.THREADS)
    groups = ddp.space_groups()
    layout = "2x2" if groups.n_data == 2 else "1x2"
    for name in CASES:
        base.rank_results(work, f"{name}_{layout}", run_rcnn(name, groups, layout))
    if layout == "2x2":
        return
    torch.save(gradchecks(groups), f"{work}/gradchecks_rank{ddp.rank()}.pt")
    torch.save(head_grads_without_row_split(groups), f"{work}/no_split_rank{ddp.rank()}.pt")
    jax_eval(work, groups)
