"""Anchor NeRF-RPN command line, torch port: ``--mode train | eval | benchmark``.

Port of ``nerf_rpn_tpu/cli/run_rpn.py`` for every backbone of the JAX
table (Swin, ``resnet`` / ``resnet_tiny`` and ``vgg_AF`` / ``vgg_EF``, whose
stem follows ``--resolution``) with axis-aligned boxes, or oriented ones
with ``--rotated_bbox`` (the midpoint-offset coder, 8 deltas an anchor),
with the smooth-L1 box loss or, for OBBs, ``--reg_loss_type
iou|linear_iou|giou|diou``, in f32 or ``--bf16``, on one device or, for
``--mode train``, data parallel over ``--gpus`` (``parallel/ddp.py``).
The flags are the JAX CLI's flags, plus:

- ``--weights <npz>``: a flax variables tree flattened to ``a/b/c`` keys
  (``nerf_rpn_tpu_torch.weights.save_npz``; params and, for the CNN
  backbones, ``batch_stats``); without it (and without ``--checkpoint``)
  the weights are drawn from ``--seed`` through a ``torch.Generator``;
- ``--device``: ``cuda`` (the default) or ``cpu``.  Without a GPU the
  default raises; the CPU runs only when asked for with ``--device cpu``.

``--mode train`` is ``Trainer.train_loop`` of the JAX CLI: shuffled,
augmented batches (``drop_last``), AdamW with optax's one-cycle schedule
and clip, a log line every ``--log_interval`` steps, a validation eval
every ``--eval_interval`` epochs, ``epoch_N`` and ``model_best`` (by the
last validation recall) checkpoints in ``--save_path`` (``torch.save``,
the reference layout, BatchNorm statistics included), pruned to
``--keep_checkpoints``.  ``--checkpoint`` (with ``--load_backbone_only``)
loads such a file for train and eval.  ``--mode eval`` takes
``--output_all`` (train, validation and test scenes in turn) and
``--save_results`` (the FPN levels and proposals that the RCNN stage
reads, under ``--save_results_path`` or ``<save_path>/results``);
``--check_arch`` builds the model, logs its parameter count and stops.

``--gpus 0-3`` (or ``0,1,2,3``) trains with one rank a listed GPU (NCCL):
each rank takes ``--batch_size / world`` scenes of the global batch a step
(its share of the shuffled order, as ``DistributedSampler`` gives it), and
the step is the global batch's (global loss normalisers and BatchNorm
statistics, gradients summed over the ranks).  Rank 0 alone evaluates,
writes the checkpoints and the log file; every rank then meets at the
epoch-end barrier.  torchrun's environment puts the process in its group
instead (gloo with ``--device cpu``).  ``--mode eval|benchmark`` runs on
the first listed GPU.

The backbones' levels must sit at strides (4, 8, 16, 32): VGG below
``--resolution`` 160 has a stride-1 stem and raises a ``ValueError``
(the JAX driver fails at its first eval there).

Datasets, ``unmask_proposals``, the proposals npz and the Recall/AP report
with its ``eval.json`` are the port's copies of the JAX package's host code
(``cli/common.py``, ``data/``, ``evaluation/metrics.py``).
Refused: an IoU ``--reg_loss_type`` without ``--rotated_bbox`` (the JAX
package computes no AABB IoU there).  Not ported yet: ``--wandb``; orbax
and ``.msgpack`` checkpoints are not read.

Example::

    python -m nerf_rpn_tpu_torch.cli.run_rpn --mode train --backbone_type swin_s \\
        --bf16 --rotated_bbox --features_path data --boxes_path data \\
        --dataset_split data/split.npz --save_path out --resolution 160 \\
        --batch_size 2 --num_epochs 1
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from nerf_rpn_tpu_torch import weights as weights_lib
from nerf_rpn_tpu_torch.cli import common
from nerf_rpn_tpu_torch.data.datasets import batch_iterator, round_up
from nerf_rpn_tpu_torch.data.loader import prefetch_iterator
from nerf_rpn_tpu_torch.device import resolve_device
from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN, init_params
from nerf_rpn_tpu_torch.models.rpn import RPNConfig
from nerf_rpn_tpu_torch.parallel import ddp
from nerf_rpn_tpu_torch.train import checkpoint as ckpt_lib
from nerf_rpn_tpu_torch.train.state import TrainState
from nerf_rpn_tpu_torch.train.steps import (make_rpn_eval_step,
                                               make_rpn_train_step)

STRIDES = (4, 8, 16, 32)
BENCH_SHAPE = (200, 200, 130)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train, eval and benchmark the NeRF RPN (PyTorch + CUDA port).")
    p.add_argument("--mode", default="train", choices=["train", "eval", "benchmark"])
    p.add_argument("--dataset_name", "-dn", default="hypersim",
                   choices=["hypersim", "front3d", "general", "scannet"])
    p.add_argument("--features_path", default="")
    p.add_argument("--boxes_path", default="")
    p.add_argument("--save_path", default="")
    p.add_argument("--dataset_split", default="")
    p.add_argument("--preload", action="store_true")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--load_backbone_only", action="store_true")
    p.add_argument("--backbone_type", default="swin_s",
                   choices=["resnet", "resnet_tiny", "vgg_AF", "vgg_EF",
                            "swin_t", "swin_s", "swin_b", "swin_l"])
    p.add_argument("--freeze_backbone", action="store_true")
    p.add_argument("--train_csv", default="")
    p.add_argument("--val_csv", default="")
    p.add_argument("--test_csv", default="")
    p.add_argument("--resolution", type=int, default=160)
    p.add_argument("--rotated_bbox", action="store_true")
    p.add_argument("--normalize_density", action="store_true")
    p.add_argument("--output_proposals", action="store_true")
    p.add_argument("--output_voxel_scores", action="store_true")
    p.add_argument("--filter", choices=["none", "tp", "fp"], default="none")
    p.add_argument("--filter_threshold", type=float, default=0.7)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--rotate_prob", type=float, default=0.5)
    p.add_argument("--flip_prob", type=float, default=0.5)
    p.add_argument("--rot_scale_prob", type=float, default=0.5)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--reg_loss_weight", type=float, default=5.0)
    p.add_argument("--reg_loss_weight_2d", type=float, default=0.0)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--clip_grad_norm", type=float, default=0.1)
    p.add_argument("--log_to_file", action="store_true")
    p.add_argument("--log_interval", type=int, default=20)
    p.add_argument("--eval_interval", type=int, default=1)
    p.add_argument("--keep_checkpoints", type=int, default=1)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--gpus", default="",
                   help="GPUs to train on, one rank each: 0-3 or 0,1,2,3 (NCCL).")
    p.add_argument("--rpn_head_conv_depth", type=int, default=4)
    p.add_argument("--rpn_pre_nms_top_n_train", type=int, default=2500)
    p.add_argument("--rpn_pre_nms_top_n_test", type=int, default=2500)
    p.add_argument("--rpn_post_nms_top_n_train", type=int, default=2500)
    p.add_argument("--rpn_post_nms_top_n_test", type=int, default=2500)
    p.add_argument("--rpn_nms_thresh", type=float, default=0.3)
    p.add_argument("--rpn_fg_iou_thresh", type=float, default=0.35)
    p.add_argument("--rpn_bg_iou_thresh", type=float, default=0.2)
    p.add_argument("--rpn_batch_size_per_mesh", type=int, default=256)
    p.add_argument("--rpn_positive_fraction", type=float, default=0.5)
    p.add_argument("--rpn_score_thresh", type=float, default=0.0)
    p.add_argument("--reg_loss_type", default="smooth_l1",
                   choices=["smooth_l1", "iou", "linear_iou", "giou", "diou"])
    p.add_argument("--check_arch", action="store_true",
                   help="Build the model, log its parameter count and stop.")
    p.add_argument("--save_results", action="store_true",
                   help="--mode eval: write the FPN levels and proposals of each scene "
                        "(the RCNN stage's input).")
    p.add_argument("--save_results_path", default="")
    p.add_argument("--output_all", action="store_true",
                   help="--mode eval: evaluate the train, validation and test scenes.")
    p.add_argument("--pad_multiple", type=int, default=32)
    p.add_argument("--max_gt", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=4,
                   help="Sample-loading threads; 0 = load in-line.")
    p.add_argument("--prefetch_batches", type=int, default=2,
                   help="Batches assembled ahead of the step; 0 disables "
                        "background prefetch.")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute path.")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--weights", default="",
                   help="npz of the flax params tree (a/b/c keys); "
                        "default: random weights from --seed.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) | cpu.")
    args = p.parse_args(argv)
    if args.wandb:
        raise NotImplementedError("--wandb is not ported to torch (ROADMAP.md)")
    ddp.parse_gpus(args.gpus)
    return args


class Trainer:
    """Holds the model, its device and the steps of one CLI run."""

    def __init__(self, args):
        self.args = args
        self.logger = common.setup_logger(args.save_path, args.log_to_file,
                                          "run_rpn_torch", ddp.rank())
        self.device = resolve_device(args.device)
        self.dtype = torch.bfloat16 if args.bf16 else torch.float32
        if self.device.type == "cuda" and not args.bf16:
            # f32 means f32: no TF32 in cuDNN convolutions or matmuls
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        side = round_up(args.resolution, args.pad_multiple)
        self.mesh_shape = (side, side, side)
        self.box_dim = 7 if args.rotated_bbox else 6
        self.model = NeRFRPN(args.backbone_type, conv_depth=args.rpn_head_conv_depth,
                             rotated=args.rotated_bbox, dtype=self.dtype,
                             resolution=args.resolution)
        if args.weights:
            weights_lib.load_weights_npz(self.model, args.weights)
            self.logger.info(f"Loaded weights {args.weights}")
        else:
            init_params(self.model, torch.Generator().manual_seed(args.seed))
        if args.checkpoint:
            ckpt_lib.restore_checkpoint(self.model, args.checkpoint,
                                        backbone_only=args.load_backbone_only)
            self.logger.info(f"Loaded checkpoint {args.checkpoint}")
        self.model.to(self.device).eval()
        ddp.broadcast_module_(self.model)
        self.cfg_train = self._make_cfg(args.rpn_pre_nms_top_n_train,
                                        args.rpn_post_nms_top_n_train)
        self.cfg = self._make_cfg(args.rpn_pre_nms_top_n_test,
                                  args.rpn_post_nms_top_n_test)
        self.state = None

    def _make_cfg(self, pre_nms: int, post_nms: int) -> RPNConfig:
        a = self.args
        return RPNConfig(
            rotated=a.rotated_bbox,
            fg_iou_thresh=a.rpn_fg_iou_thresh,
            bg_iou_thresh=a.rpn_bg_iou_thresh,
            batch_size_per_mesh=a.rpn_batch_size_per_mesh,
            positive_fraction=a.rpn_positive_fraction,
            pre_nms_top_n=pre_nms,
            post_nms_top_n=post_nms,
            nms_thresh=a.rpn_nms_thresh,
            score_thresh=a.rpn_score_thresh,
            reg_loss_type=a.reg_loss_type,
            reg_loss_weight=a.reg_loss_weight,
            reg_loss_weight_2d=a.reg_loss_weight_2d,
        )

    def eval_step(self, mesh_shape, return_features: bool = False):
        return make_rpn_eval_step(self.model, self.cfg, mesh_shape, STRIDES,
                                  device=self.device, return_features=return_features)

    def param_count(self) -> int:
        """The number of trained values (flax's count of ``params``: the
        BatchNorms' running statistics are buffers)."""
        return sum(p.numel() for p in self.model.parameters())

    # -- train --------------------------------------------------------------

    def train_loop(self) -> list[dict[str, float]]:
        """Returns the logged metrics (one dict per log line)."""
        args = self.args
        local_batch = common.local_batch_size(args.batch_size, ddp.world())
        train_set, val_set, _ = common.build_datasets(args, "train", augment=True)
        self.logger.info(
            f"Loaded {len(train_set)} training scenes, {len(val_set)} validation scenes")
        steps_per_epoch = max(1, len(train_set) // args.batch_size)
        self.state = TrainState(
            self.model, args.lr, args.num_epochs * steps_per_epoch, args.weight_decay,
            args.clip_grad_norm, freeze_backbone=args.freeze_backbone)
        train_step = make_rpn_train_step(self.model, self.cfg_train, self.mesh_shape,
                                         STRIDES, device=self.device)
        os.makedirs(args.save_path, exist_ok=True)
        # separate streams for anchor sampling and stochastic depth
        seed = ddp.seed_for_rank(args.seed)
        gen = torch.Generator(self.device).manual_seed(seed)
        drop_gen = torch.Generator(self.device).manual_seed(seed + 1)
        best_metric, logged = None, []
        for epoch in range(1, args.num_epochs + 1):
            it = batch_iterator(
                train_set, local_batch, shuffle=True, seed=epoch, drop_last=True,
                process_index=ddp.rank(), process_count=ddp.world(),
                pad_multiple=args.pad_multiple, max_gt=args.max_gt, box_dim=self.box_dim,
                fixed_shape=self.mesh_shape, num_workers=args.num_workers)
            for i, batch in enumerate(prefetch_iterator(it, depth=args.prefetch_batches)):
                t0 = time.perf_counter()
                batch = common.device_batch(batch, self.device, self.dtype)
                metrics = train_step(self.state, batch, gen, drop_gen)
                if i % args.log_interval == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    logged.append(dict(metrics, epoch=epoch, iter=i))
                    self.logger.info(
                        f"Epoch {epoch} [{i}] loss {metrics['loss']:.4f} "
                        f"obj {metrics['loss_objectness']:.4f} "
                        f"reg {metrics['loss_rpn_box_reg']:.4f} "
                        f"reg2d {metrics['loss_rpn_box_reg_2d']:.4f} "
                        f"grad_norm {metrics['grad_norm']:.4f} "
                        f"({time.perf_counter() - t0:.2f}s/it)")
            if ddp.is_main() and (epoch % args.eval_interval == 0
                                  or epoch == args.num_epochs):
                recalls, _ = self.eval(val_set, write_json=False)
                metric = recalls[-1] if recalls else -1.0
                if best_metric is None or metric > best_metric:
                    best_metric = metric
                    ckpt_lib.save_checkpoint(
                        self.state, os.path.join(args.save_path, "model_best"),
                        vars(args), epoch)
                ckpt_lib.save_checkpoint(
                    self.state, os.path.join(args.save_path, f"epoch_{epoch}"),
                    vars(args), epoch)
                ckpt_lib.delete_old_checkpoints(args.save_path, args.keep_checkpoints)
            ddp.barrier()
        return logged

    # -- eval ---------------------------------------------------------------

    def save_results(self, names, out, levels):
        """The JAX driver's ``_save_results`` files for the RCNN stage: per
        scene ``features/{name}.npz`` (``level_features``, an object array of
        the flattened f32 (C, X, Y, Z) levels, and ``resolution``, their
        shapes) and ``proposals/{name}.npz`` (the valid proposals'
        ``proposals[:, :box_dim]`` and ``level_indices``)."""
        args = self.args
        root = args.save_results_path or os.path.join(args.save_path, "results")
        feat_dir = os.path.join(root, "features")
        roi_dir = os.path.join(root, "proposals")
        os.makedirs(feat_dir, exist_ok=True)
        os.makedirs(roi_dir, exist_ok=True)
        feats = [f.cpu().numpy() for f in out["features"]]
        boxes = out["boxes"].float().cpu().numpy()
        valid = out["valid"].cpu().numpy()
        for i, name in enumerate(names):
            per_level = [np.moveaxis(f[i], -1, 0) for f in feats]
            np.savez(os.path.join(feat_dir, f"{name}.npz"),
                     level_features=np.array([f.reshape(-1).astype(object) for f in per_level],
                                             dtype=object),
                     resolution=np.array([f.shape for f in per_level]))
            np.savez(os.path.join(roi_dir, f"{name}.npz"),
                     proposals=boxes[i][valid[i]][:, :self.box_dim], level_indices=levels[i])

    def eval(self, dataset, write_json: bool = True):
        args = self.args
        eval_step = self.eval_step(self.mesh_shape, return_features=args.save_results)
        it = batch_iterator(
            dataset, args.batch_size, shuffle=False,
            pad_multiple=args.pad_multiple, max_gt=args.max_gt, box_dim=self.box_dim,
            fixed_shape=self.mesh_shape, num_workers=args.num_workers)
        proposals_list, scores_list, gt_boxes_list, scenes_list = [], [], [], []
        for batch in prefetch_iterator(it, depth=args.prefetch_batches):
            names, gt_mask = batch["names"], batch["gt_mask"]
            grids = torch.from_numpy(batch["grids"]).to(self.device, self.dtype)
            ori = torch.from_numpy(batch["ori_sizes"]).to(self.device)
            out = eval_step(grids, ori)
            host = {k: v.float().cpu().numpy() if v.is_floating_point()
                    else v.cpu().numpy()
                    for k, v in out.items() if k not in ("voxel_scores", "features")}
            props, scs, lvls = common.unmask_proposals(host, self.box_dim)
            if args.save_results:
                self.save_results(names, out, lvls)
            proposals_list.extend(props)
            scores_list.extend(scs)
            scenes_list.extend(names)
            for i in range(len(names)):
                gt_boxes_list.append(
                    batch["gt_boxes"][i][gt_mask[i]][:, :self.box_dim] if gt_mask[i].any()
                    else np.zeros((0, self.box_dim), np.float32))
            if args.output_voxel_scores:
                for i, name in enumerate(names):
                    common.output_voxel_scores_npz(
                        args.save_path, name,
                        [v[i].float().cpu().numpy() for v in out["voxel_scores"]],
                        batch["ori_sizes"][i], STRIDES)
        if args.output_proposals:
            common.output_proposals_npz(
                args.save_path, scenes_list, proposals_list, scores_list,
                gt_boxes_list, args.filter, args.filter_threshold)
        if not any(len(g) for g in gt_boxes_list):
            return None, None
        return common.report_metrics(
            proposals_list, scores_list, gt_boxes_list, args, self.logger,
            args.rpn_post_nms_top_n_test, write_json=write_json)

    # -- benchmark ----------------------------------------------------------

    def benchmark(self, reps=300, warmup=10) -> dict[str, float]:
        """Reference protocol (``run_rpn.py:594-617``): a random
        200x200x130 grid padded to ``--pad_multiple``; mean device ms per
        scene over ``reps`` eval steps after ``warmup``, timed with CUDA
        events after ``torch.cuda.synchronize()``, split into forward and
        propose."""
        if self.device.type != "cuda":
            raise RuntimeError("--mode benchmark times the GPU; it needs "
                               "--device cuda")
        shape = tuple(round_up(s, self.args.pad_multiple) for s in BENCH_SHAPE)
        eval_step = self.eval_step(shape)
        rng = np.random.default_rng(self.args.seed)
        grids = torch.from_numpy(
            rng.standard_normal((1, *shape, 4), np.float32)).to(self.device, self.dtype)
        ori = torch.tensor([BENCH_SHAPE], dtype=torch.int32, device=self.device)

        def forward():
            _, obj, dl, _ = eval_step.forward(grids)
            return obj, dl, ori

        res = common.benchmark_eval_step(forward, eval_step.propose, reps, warmup,
                                         self.logger, self.device)
        return dict(res, shape=shape)


def main(argv=None):
    return ddp.run_driver(_run, parse_args(argv))


def _run(args):
    trainer = Trainer(args)
    if args.check_arch:
        n = trainer.param_count()
        trainer.logger.info(f"Model builds OK; {n / 1e6:.2f}M params")
        return n
    if args.mode == "train":
        return trainer.train_loop()
    if args.mode == "eval":
        return common.eval_datasets(args, trainer.eval)
    return trainer.benchmark()


if __name__ == "__main__":
    main()
