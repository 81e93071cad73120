"""Cases and rank code of the FCOS and VGG ``space``-axis tests
(``test_torch_space_fcos.py``, ``test_torch_space_vgg.py``).

FCOS cases run ``make_fcos_eval_step`` / ``make_fcos_train_step`` in f64,
in one process on a global batch of two unlike scenes
(``torch_space_cases.grids``) or, with ``groups``, on a rank's part of it:

- ``fcos_swin_aabb_64``: the narrow Swin of ``torch_space_cases`` with
  64-channel levels, one tower conv, at 64 x 8 x 24, AABB -- stages 2 and
  3 have one window column, so the second rank's GroupNorms there sum an
  empty slab.  Two channels a group keep the GroupNorm of level 3 (2
  voxels a scene) well conditioned: at 32 channels, one a group, its
  ``E[x^2] - E[x]^2`` cancels ~6 digits and the f64 gradients of any two
  summation orders part by ~1e-10;
- ``fcos_resnet_tiny_obb_32``: ``resnet_tiny`` at 32 x 40 x 40, OBB
  (GroupNorms of one channel a group, train-mode BatchNorm); its last level
  is one row, none on the second rank.  It also runs at ``(n_data,
  n_space) = (2, 2)``: FCOS draws nothing, so the step is the one
  process's on any layout.

The VGG case is the anchor RPN of ``torch_space_cases.run_case`` on
``vgg_AF`` with ``input_size`` 160 (a stride-2 stem and the stem pool) at
40 x 16 x 16: level 0 has 10 rows (5 a rank), so the first 2^3 ceil-mode
pool's windows straddle the split, and its 5 output rows make the second
pool's last window read one row and the -inf past the global edge.

Also here: the gradchecks of the space group's all-reduce and of the slab
GroupNorm, and the rank side of the comparisons with JAX's space path.  The
module imports no JAX, so that spawned ranks start quickly.
"""

import torch
from torch import nn

import torch_space_cases as base
from nerf_rpn_tpu_torch.models.fcos import FCOSConfig
from nerf_rpn_tpu_torch.models.heads import FCOSHead3D
from nerf_rpn_tpu_torch.models.layers import group_norm
from nerf_rpn_tpu_torch.models.nerf_rpn import FCOSOverNeRF, NeRFRPN, init_params
from nerf_rpn_tpu_torch.models.rpn import RPNConfig
from nerf_rpn_tpu_torch.models.swin import SwinFPN
from nerf_rpn_tpu_torch.parallel import ddp
from nerf_rpn_tpu_torch.parallel import space as sp
from nerf_rpn_tpu_torch.train.state import TrainState
from nerf_rpn_tpu_torch.train.steps import make_fcos_eval_step, make_fcos_train_step, \
    make_rpn_eval_step

F64 = base.F64
SWIN_WIDTH = 64
FCOS_CASES = {
    "fcos_swin_aabb_64": dict(backbone="swin", shape=(64, 8, 24), rotated=False),
    "fcos_resnet_tiny_obb_32": dict(backbone="resnet_tiny", shape=(32, 40, 40), rotated=True),
}
# the case that also runs at (2, 2)
FCOS_2X2 = "fcos_resnet_tiny_obb_32"
VGG_CASE = "vgg_af_aabb_40"
VGG_SPEC = dict(backbone="vgg_AF", shape=(40, 16, 16), rotated=False, resolution=160)
GRADCHECKS = ("all_reduce", "group_norm", "group_norm_empty")


# ---------------------------------------------------------------------------
# FCOS
# ---------------------------------------------------------------------------


def fcos_setup(name):
    """``(model, cfg, batch)`` of an FCOS case, the same in every process."""
    spec = FCOS_CASES[name]
    shape, rotated = spec["shape"], spec["rotated"]
    if spec["backbone"] == "swin":
        model = FCOSOverNeRF("swin_t", num_convs=1, rotated=rotated, dtype=F64)
        model.backbone = SwinFPN(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4),
                                 out_channels=SWIN_WIDTH, dtype=F64)
        model.fcos_head = FCOSHead3D(SWIN_WIDTH, 4, 1, rotated, dtype=F64)
    else:
        model = FCOSOverNeRF(spec["backbone"], num_convs=1, rotated=rotated, dtype=F64,
                             resolution=shape[0])
    init_params(model, torch.Generator().manual_seed(1))
    model.to(F64)
    base.randomise_running_stats(model)
    with torch.no_grad():
        g = torch.Generator().manual_seed(2)
        for n, t in model.named_buffers():
            if n.endswith("running_mean"):  # centred: a mean of ~1 leaves resnet_tiny's
                t.sub_(1.0)                 # levels all 0 after the ReLUs
        # GroupNorm affines that are not 1 / 0
        for m in model.fcos_head.modules():
            if isinstance(m, nn.GroupNorm):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape, generator=g, dtype=F64))
                m.bias.copy_(0.5 + 0.1 * torch.randn(m.bias.shape, generator=g, dtype=F64))
    cfg = FCOSConfig(rotated=rotated, iou_loss_type="iou" if rotated else "giou",
                     pre_nms_top_n=300, fpn_post_nms_top_n=100)
    gt, mask = base.gt_boxes(shape, rotated)
    batch = {"grids": base.grids(shape), "gt_boxes": gt, "gt_mask": mask,
             "ori_sizes": torch.tensor([shape, [shape[0] - 2, *shape[1:]]], dtype=torch.int32)}
    return model, cfg, batch


def run_fcos(name, groups=None):
    """An FCOS case's eval (the gathered, flattened head outputs, the voxel
    scores and the proposals), then its train step: the metrics, the
    gradients before any sum over the ranks, and the weights after the
    update."""
    model, cfg, batch = fcos_setup(name)
    shape = FCOS_CASES[name]["shape"]
    part = batch if groups is None else sp.shard_batch(batch, groups)
    step = make_fcos_eval_step(model, cfg, shape, space=groups)
    heads = step.forward(part["grids"])
    proposals = step(part["grids"], part["ori_sizes"])
    state = TrainState(model, base.LR, base.TOTAL)
    grads, apply = {}, state.apply_gradients

    def capture():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        return apply()

    state.apply_gradients = capture
    train = make_fcos_train_step(model, cfg, shape, space=groups)
    metrics = train(state, part, torch.Generator().manual_seed(1))
    return {"heads": heads, "proposals": proposals,
            "metrics": {k: v.item() for k, v in metrics.items()}, "grads": grads,
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


# ---------------------------------------------------------------------------
# The gradchecks
# ---------------------------------------------------------------------------


def _gradcheck_fn(kind, groups):
    """A global input of 5 rows -> the gathered outputs of a slab op."""
    bounds = ((0, 5), (5, 5)) if kind == "group_norm_empty" else ((0, 3), (3, 5))
    slab = sp.Slab(groups, bounds, 5)
    if kind == "all_reduce":
        # out[i] = x[i] * sum_j x[j]: the replicated sum read by each rank's
        # own rows, as a GroupNorm reads its moments
        def fn(x):
            return x * sp.all_reduce_sum(x.sum(1, keepdim=True), groups)
    else:
        gn = nn.GroupNorm(2, 4).to(F64)
        with torch.no_grad():
            g = torch.Generator().manual_seed(6)
            gn.weight.copy_(1 + 0.3 * torch.randn(4, generator=g, dtype=F64))
            gn.bias.copy_(0.3 * torch.randn(4, generator=g, dtype=F64))

        def fn(x):
            return group_norm(x, gn, F64, slab)
    return lambda xg: sp.gather_x(fn(base._Scatter.apply(xg, slab)), slab)


def gradchecks(groups):
    ok = {}
    for kind in GRADCHECKS:
        x = torch.randn((2, 5, 2, 1, 4), dtype=F64,
                        generator=torch.Generator().manual_seed(5), requires_grad=True)
        try:
            ok[kind] = torch.autograd.gradcheck(_gradcheck_fn(kind, groups), (x,))
        except Exception as e:  # recorded, asserted in the main process
            ok[kind] = repr(e)
    return ok


# ---------------------------------------------------------------------------
# The comparisons with JAX: the port's side (f32)
# ---------------------------------------------------------------------------

# the FCOS model of the comparison: ``resnet_tiny`` at 32^3, one tower conv
FCOS_JAX_SHAPE = (32, 32, 32)
FCOS_JAX_CFG = dict(pre_nms_top_n=300, fpn_post_nms_top_n=100)
# the VGG RPN of the comparison: ``vgg_AF`` at input size 160 on VGG_SPEC's grid
VGG_JAX_CFG = dict(pre_nms_top_n=300, post_nms_top_n=100)


def fcos_jax_eval(work, groups):
    """The port's FCOS eval of JAX's weights on this rank's slab."""
    model = FCOSOverNeRF("resnet_tiny", num_convs=1, resolution=32)
    model.load_state_dict(torch.load(f"{work}/fcos_weights.pt"), strict=True)
    part = sp.shard_batch(torch.load(f"{work}/fcos_batch.pt"), groups)
    step = make_fcos_eval_step(model, FCOSConfig(**FCOS_JAX_CFG), FCOS_JAX_SHAPE, space=groups)
    torch.save(step(part["grids"], part["ori_sizes"]), f"{work}/fcos_eval_rank{ddp.rank()}.pt")


def vgg_jax_eval(work, groups):
    """The port's ``vgg_AF`` RPN eval of JAX's weights on this rank's slab."""
    model = NeRFRPN("vgg_AF", conv_depth=1, resolution=160)
    model.load_state_dict(torch.load(f"{work}/vgg_weights.pt"), strict=True)
    part = sp.shard_batch(torch.load(f"{work}/vgg_batch.pt"), groups)
    step = make_rpn_eval_step(model, RPNConfig(**VGG_JAX_CFG), VGG_SPEC["shape"], space=groups)
    torch.save(step(part["grids"], part["ori_sizes"]), f"{work}/vgg_eval_rank{ddp.rank()}.pt")


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def fcos_ranks(work):
    """A rank of ``test_torch_space_fcos.py``: at (1, 2) every FCOS case,
    the gradchecks and the port's side of the comparison with JAX; at
    (2, 2) the one case of that layout."""
    torch.set_num_threads(base.THREADS)
    groups = ddp.space_groups()
    if groups.n_data == 2:
        base.rank_results(work, f"{FCOS_2X2}_2x2", run_fcos(FCOS_2X2, groups))
        return
    for name in FCOS_CASES:
        base.rank_results(work, name, run_fcos(name, groups))
    torch.save(gradchecks(groups), f"{work}/gradchecks_rank{ddp.rank()}.pt")
    fcos_jax_eval(work, groups)


def vgg_ranks(work):
    """A rank of ``test_torch_space_vgg.py``: the VGG case on its slab and
    the port's side of the comparison with JAX."""
    torch.set_num_threads(base.THREADS)
    groups = ddp.space_groups()
    base.rank_results(work, VGG_CASE, base.run_case(VGG_CASE, groups, spec=VGG_SPEC))
    vgg_jax_eval(work, groups)
