"""Data-parallel train steps (``parallel/ddp.py``) against the step of one
process on the same global batch, and against JAX's.

Two ranks (spawned processes, gloo, a ``file://`` rendezvous in the test's
temporary directory) each take one scene of a batch of 2; the port's step
in this process takes both.  Every rank builds the same weights, rank 1
then shifts all of its parameters and buffers, and ``broadcast_module_``
must give it rank 0's back.  The anchor (RoI) sample is drawn once on the
whole batch and each rank takes its scene's rows; drop-path is off.

Cases, in f64: the anchor RPN on ``swin_t`` with AABBs (smooth-L1 and the
2D projection term) and with OBBs (the rotated IoU loss and the 2D term),
on ``resnet_tiny`` with two unlike scenes and running statistics that are
not 0 / 1 (train-mode BatchNorm over the global batch), FCOS with OBBs
(``train_fcos.sh``'s loss flags) and the RCNN features-mode step (a scene
with fewer valid RoIs than the other).  At world 2 the loss terms,
``grad_norm`` and ``param_norm``, the sum of the ranks' gradients, every
updated parameter and running statistic must be the one-process step's
within 1e-10 (relative: a term to its value, a gradient leaf or running
statistic to its largest entry, a parameter to 1 or its leaf's largest
entry), and the two ranks' weights after the step bit-equal.  At world 1 (a group
of one) every helper is a no-op: the RPN step on ``resnet_tiny`` and the
RCNN step are bit-identical to the steps without a group.

``test_torch_train_step_resnet.py`` holds the ``resnet_tiny`` world-2 step
to JAX's step at batch 2 through :func:`world2_steps` and a saved case.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from nerf_rpn_tpu_torch.models import detector as det
from nerf_rpn_tpu_torch.models import rpn
from nerf_rpn_tpu_torch.models.fcos import FCOSConfig
from nerf_rpn_tpu_torch.models.nerf_rpn import FCOSOverNeRF, NeRFRPN, init_params
from nerf_rpn_tpu_torch.models.swin import SwinBlock
from nerf_rpn_tpu_torch.parallel import ddp
from nerf_rpn_tpu_torch.train.state import TrainState
from nerf_rpn_tpu_torch.train.steps import (level_shapes_for, make_fcos_train_step,
                                               make_rcnn_train_step, make_rpn_train_step)

SHAPE = (32, 32, 32)
STRIDES = (4, 8, 16, 32)
LR, TOTAL = 1e-3, 10
F64 = torch.float64
CPU = torch.device("cpu")
CASES = ("rpn_swin_aabb", "rpn_swin_obb", "rpn_resnet_tiny", "fcos_obb", "rcnn_features")
# an RPN step of weights, a batch and a sample written by another test
# (``save_case``)
SAVED = "saved"


# ---------------------------------------------------------------------------
# The cases: a model, the global batch, the injected sample and the step
# ---------------------------------------------------------------------------


def _grids(rng, shape=SHAPE):
    """Two unlike scenes: noise, and a ramp along x with a dense block.  At
    32^3 ``resnet_tiny``'s last level is 1^3, so its train-mode BatchNorms
    normalise 2 values a channel, one a rank; where the two scenes' deep
    features nearly agree, E[x^2] - E[x]^2 cancels and turns f64 rounding
    (a convolution over one scene or two) into ~5e-10 of a gradient leaf,
    in any two implementations (``test_torch_rcnn_train_step.py``)."""
    g = rng.uniform(0, 1, (2, *shape, 4))
    g[1] = 0.1 * g[1] + 3.0 * np.linspace(0, 1, shape[0])[:, None, None, None] ** 2
    g[1, 4:20, 8:28, 6:30, 3] += 4.0
    g[1, ..., 1] *= -1
    return torch.from_numpy(g)


AABB_GT = [[[4, 6, 8, 14, 12, 18], [16, 16, 8, 28, 30, 20], [4, 20, 20, 12, 30, 31]],
           [[0, 0, 0, 20, 16, 12], [10, 12, 14, 18, 20, 24], [0, 0, 0, 0, 0, 0]]]
OBB_GT = [[[8, 8, 11, 10, 7, 12, 0.4], [22, 23, 14, 9, 12, 10, -1.1], [8, 25, 25, 6, 9, 9, 1.3]],
          [[10, 8, 6, 18, 14, 10, -0.2], [14, 16, 19, 7, 9, 8, 0.8], [0, 0, 0, 0, 0, 0, 0]]]


def _rpn_batch(rng, rotated):
    gt = torch.tensor(OBB_GT if rotated else AABB_GT, dtype=F64)
    return {"grids": _grids(rng), "gt_boxes": gt, "gt_mask": gt[..., 3] > 0,
            "ori_sizes": torch.tensor([[32, 30, 32], [28, 32, 26]], dtype=torch.int32)}


def _no_drop_path(model):
    for m in model.modules():
        if isinstance(m, SwinBlock):
            m.drop_path = 0.0


def save_case(work, model, batch, indices, shape, freeze=False):
    """Writes an RPN train step's weights (``model``'s), global batch and
    anchor sample for :func:`world2_steps`' case ``SAVED``."""
    torch.save({"state": model.state_dict(), "backbone": model.backbone_type,
                "conv_depth": model.conv_depth, "batch": batch, "indices": indices,
                "shape": shape, "freeze": freeze}, f"{work}/{SAVED}.pt")


def _setup(case, work):
    """``(model, batch, indices, run, freeze)``, the same in every process:
    ``run(model, state, batch, indices) -> metrics``."""
    if case == SAVED:
        saved = torch.load(f"{work}/{SAVED}.pt", weights_only=False)
        model = NeRFRPN(saved["backbone"], conv_depth=saved["conv_depth"])
        model.load_state_dict(saved["state"], strict=True)
        return (model, saved["batch"], saved["indices"],
                _rpn_run(rpn.RPNConfig(), saved["shape"]), saved["freeze"])
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    if case.startswith("rpn_"):
        rotated = case == "rpn_swin_obb"
        backbone = "resnet_tiny" if case == "rpn_resnet_tiny" else "swin_t"
        model = NeRFRPN(backbone, conv_depth=1, rotated=rotated, dtype=F64, resolution=32)
        cfg = rpn.RPNConfig(rotated=rotated, reg_loss_weight=5.0, reg_loss_weight_2d=0.5,
                            reg_loss_type="iou" if rotated else "smooth_l1")
        batch = _rpn_batch(rng, rotated)
        shapes = level_shapes_for(SHAPE, STRIDES)
        anchors, _, level_strides, _ = rpn.build_level_tables(cfg, SHAPE, shapes)
        pad = rpn.dynamic_padding_masks(shapes, level_strides, 13, batch["ori_sizes"])
        matches = rpn.assign_anchors(cfg, torch.from_numpy(anchors).to(F64),
                                     batch["gt_boxes"], batch["gt_mask"], pad)
        indices = list(rpn.sample_anchors(cfg, matches, gen))
        run = _rpn_run(cfg, SHAPE)
    elif case == "fcos_obb":
        model = FCOSOverNeRF("swin_t", num_convs=1, rotated=True, fpn_strides=STRIDES,
                             dtype=F64, resolution=32)
        cfg = FCOSConfig(rotated=True, center_sampling_radius=1.5, iou_loss_type="iou",
                         norm_reg_targets=True)
        batch, indices = _rpn_batch(rng, rotated=True), None

        def run(model, state, batch, indices):
            step = make_fcos_train_step(model, cfg, SHAPE)
            return step(state, batch, torch.Generator().manual_seed(1))
    else:
        cfg = det.RCNNConfig(output_size=(2, 2, 2), fg_threshold=0.3, bg_threshold=0.25)
        model = det.RCNNDetector(det.RCNNHead(16, 2, False, True, True, (2, 2, 2), F64))
        gt = torch.tensor([g[:2] for g in AABB_GT], dtype=F64)
        rois = []
        for scene in gt:  # jittered copies of the gt, then random boxes
            boxes = [g + torch.from_numpy(rng.uniform(-1, 1, 6)) for g in scene for _ in range(4)]
            while len(boxes) < 40:
                c, s = rng.uniform(4, 28, 3), rng.uniform(3, 10, 3)
                boxes.append(torch.from_numpy(np.r_[c - s / 2, c + s / 2]))
            rois.append(torch.stack(boxes))
        valid = torch.ones((2, 40), dtype=torch.bool)
        valid[1, -9:] = False
        batch = {"rois": torch.stack(rois), "roi_valid": valid,
                 "roi_levels": torch.from_numpy(rng.integers(0, 4, (2, 40))).int(),
                 "gt_boxes": gt, "gt_mask": torch.ones((2, 2), dtype=torch.bool),
                 "features": [torch.from_numpy(rng.standard_normal((2, s, s, s, 16)))
                              for s in (8, 4, 2, 1)]}
        indices = det.sample_rois(cfg, gen, batch["rois"], batch["roi_levels"], valid,
                                  gt, batch["gt_mask"], 16)["indices"]

        def run(model, state, batch, indices):
            step = make_rcnn_train_step(model, cfg, STRIDES, 16, reg_loss_weight=5.0)
            return step(state, batch, None, indices=indices)
    init_params(model, torch.Generator().manual_seed(1))
    model.to(F64)
    _no_drop_path(model)
    with torch.no_grad():
        for name, t in model.named_buffers():
            if "running_" in name:  # statistics that are not 0 / 1
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
        if case.startswith("rpn_"):  # moderate head outputs
            model.rpn_head.cls_logits.weight.mul_(0.05)
            model.rpn_head.bbox_pred.weight.mul_(0.05)
    return model, batch, indices, run, False


def _rpn_run(cfg, shape):
    def run(model, state, batch, indices):
        step = make_rpn_train_step(model, cfg, shape, STRIDES)
        return step(state, batch, torch.Generator().manual_seed(0),
                    torch.Generator().manual_seed(1), indices=indices)
    return run


def _scene(x, r):
    """Rank r's share of a batch, an injected sample or a level list."""
    if isinstance(x, dict):
        return {k: _scene(v, r) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_scene(v, r) for v in x]
    return None if x is None else x[r:r + 1]


def _step(model, run, batch, indices, freeze=False):
    """One train step; the metrics, the trained parameters' gradients before
    any sum over the ranks, and the weights after the update."""
    state = TrainState(model, LR, TOTAL, freeze_backbone=freeze)
    grads = {}
    apply = state.apply_gradients

    def capture():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return apply()

    state.apply_gradients = capture
    metrics = run(model, state, batch, indices)
    return {"metrics": {k: v.clone() for k, v in metrics.items()}, "grads": grads,
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def _rank_steps(work, cases):
    """A rank's steps of ``cases`` (its scene of each batch).  Rank 1 shifts
    its weights before the broadcast.  Rank 0 writes ``rank0_<case>.pt``:
    the metrics, the weights after the step and the ranks' gradients summed
    (by an all-reduce of its own); each rank writes ``rank<r>_flags.pt``:
    whether the broadcast gave it rank 0's weights, and whether its weights
    and metrics after the step are rank 0's bit for bit."""
    torch.set_num_threads(2)
    r, flags = ddp.rank(), {}
    for case in cases:
        model, batch, indices, run, freeze = _setup(case, work)
        want = {k: v.clone() for k, v in model.state_dict().items()}
        if r:
            with torch.no_grad():
                for t in (*model.parameters(), *model.buffers()):
                    t.add_(1)
        ddp.broadcast_module_(model)
        equal = all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
        out = _step(model, run, _scene(batch, r), _scene(indices, r), freeze)
        for g in out["grads"].values():
            dist.all_reduce(g)
        mine = torch.cat([t.reshape(-1).double()
                          for t in (*out["state"].values(), *out["metrics"].values())])
        rank0 = mine.clone()
        dist.broadcast(rank0, 0)
        flags[case] = {"broadcast_equal": equal, "ranks_equal": torch.equal(mine, rank0)}
        if r == 0:
            torch.save(out, f"{work}/rank0_{case}.pt")
    torch.save(flags, f"{work}/rank{r}_flags.pt")


def world2_steps(work, cases):
    """Runs ``cases`` on two ranks (gloo, spawned processes, a ``file://``
    rendezvous in ``work``); returns ``(load, flags)``: ``load(case)`` reads
    rank 0's results of a case and deletes their file (hundreds of MB of
    f64 weights and gradients), ``flags`` are each rank's checks."""
    ddp.launch(_rank_steps, (str(work), cases), [CPU, CPU], "gloo",
               init_method=f"file://{work}/rendezvous")

    def load(case):
        path = f"{work}/rank0_{case}.pt"
        out = torch.load(path, weights_only=False)
        os.remove(path)
        return out

    return load, [torch.load(f"{work}/rank{r}_flags.pt") for r in (0, 1)]


def _one_process(case, work):
    model, batch, indices, run, freeze = _setup(case, work)
    return _step(model, run, batch, indices, freeze)


def _readings(want, got):
    """``got`` (two ranks) against ``want`` (one process): each metric's
    pair, each gradient leaf's and each weight's relative error -- a
    running statistic to its leaf's largest entry, a parameter to
    max(1, its leaf's largest entry): a bias that starts at 0 holds one
    Adam step, g / (|g| + 1e-8) * lr, which turns 1e-12 of a gradient near
    1e-8 into 1e-10 of the step -- and the step counts."""
    state = {}
    for k, w in want["state"].items():
        if k.endswith("num_batches_tracked"):
            state[k] = (int(got["state"][k]), int(w))
        else:
            state[k] = _rel(got["state"][k], w, 1e-30 if "running_" in k else 1.0)
    return {"metrics": {k: (got["metrics"][k].item(), w.item())
                        for k, w in want["metrics"].items()},
            "metric_names": set(got["metrics"]),
            "grads": {n: _rel(got["grads"][n], w) for n, w in want["grads"].items()},
            "grad_names": set(got["grads"]), "state": state}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's readings, and each rank's flags."""
    work = tmp_path_factory.mktemp("ddp_steps")
    load, flags = world2_steps(work, CASES)
    return {case: _readings(_one_process(case, work), load(case)) for case in CASES}, flags


def _rel(got, want, floor=1e-30):
    return (got - want).abs().max().item() / max(want.abs().max().item(), floor)


@pytest.mark.parametrize("case", CASES)
def test_broadcast_gives_every_rank_rank0s_weights(runs, case):
    _, flags = runs
    assert flags[0][case]["broadcast_equal"] and flags[1][case]["broadcast_equal"]


@pytest.mark.parametrize("case", CASES)
def test_ranks_are_bit_equal_after_the_step(runs, case):
    _, flags = runs
    assert flags[0][case]["ranks_equal"] and flags[1][case]["ranks_equal"]


@pytest.mark.parametrize("case", CASES)
def test_loss_terms_and_norms_are_the_global_batchs(runs, case):
    read = runs[0][case]
    assert read["metric_names"] == set(read["metrics"])
    assert read["metrics"]["loss"][1] > 0 and read["metrics"]["grad_norm"][1] > 0
    for k, (got, want) in read["metrics"].items():
        assert abs(got - want) <= 1e-10 * abs(want), (k, got, want)


@pytest.mark.parametrize("case", CASES)
def test_gradients_sum_to_the_global_batchs(runs, case):
    read = runs[0][case]
    assert read["grad_names"] == set(read["grads"])
    for name, err in read["grads"].items():
        assert err <= 1e-10, (name, err)


@pytest.mark.parametrize("case", CASES)
def test_updated_parameters_and_running_statistics(runs, case):
    state = runs[0][case]["state"]
    assert any("running_" in k for k in state) == (case == "rpn_resnet_tiny")
    for k, err in state.items():
        if k.endswith("num_batches_tracked"):
            assert err[0] == err[1], k
        else:
            assert err <= 1e-10, (k, err)


@pytest.mark.parametrize("case", ("rpn_resnet_tiny", "rcnn_features"))
def test_world1_group_leaves_the_step_bit_identical(case, tmp_path):
    alone = _one_process(case, tmp_path)
    in_group = ddp.launch(_one_process, (case, tmp_path), [CPU], "gloo",
                          init_method=f"file://{tmp_path}/rendezvous")
    for part in ("metrics", "grads", "state"):
        assert set(in_group[part]) == set(alone[part])
        for k, v in alone[part].items():
            assert torch.equal(in_group[part][k], v), (part, k)
