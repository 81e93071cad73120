"""Anchor-free FCOS command line, torch port: ``--mode train | eval | benchmark``.

Port of ``nerf_rpn_tpu/cli/run_fcos.py`` for every backbone of the JAX
table (Swin, ``resnet`` / ``resnet_tiny``, ``vgg_AF`` / ``vgg_EF``) with
axis-aligned boxes, or oriented ones with ``--rotated_bbox`` (6 distances
and 2 midpoint offsets a location), in f32 or ``--bf16``, on one device or,
for ``--mode train``, data parallel over ``--gpus`` as in ``run_rpn``
(``parallel/ddp.py``: rank 0 alone evaluates and writes checkpoints).
The flags are the JAX CLI's, plus ``--weights`` (a flax variables npz) and
``--device`` (``cuda``, the default, raises without a GPU; ``cpu`` only
when asked for), as in ``run_rpn``.

``--mode train`` trains with the FCOS losses (``--iou_loss_type``,
``--norm_reg_targets``, ``--center_sampling_radius``, ...), AdamW with
optax's one-cycle schedule and clip, a log line every ``--log_interval``
steps (with a warning where the loss dropped positives beyond its gather
capacity), a validation eval every ``--eval_interval`` epochs and
``epoch_N`` / ``model_best`` checkpoints (``torch.save``; the head under
``fcos_state_dict``, the reference layout).  ``--checkpoint`` loads such a
file, only its backbone with ``--load_backbone_only``.  ``--mode eval``
writes the Recall/AP report, and with ``--output_proposals``
(``--save_level_index``, ``--filter``) and ``--output_voxel_scores`` the npz
dumps, over the test scenes or, with ``--output_all``, over the train,
validation and test scenes in turn.  ``--mode benchmark`` times the eval
step on a random 160^3 grid (the reference protocol) on the card.
``--conv_at_start`` is accepted and, as in the JAX driver, reaches no
module.  VGG below ``--resolution`` 160 raises a ``ValueError``: its levels
do not sit at the FCOS strides (4, 8, 16, 32).

Refused with ``NotImplementedError``: ``--wandb``.

Example (``scripts/train_fcos.sh``'s configuration, batch 2 a card)::

    python -m nerf_rpn_tpu_torch.cli.run_fcos --mode train --backbone_type swin_s \\
        --bf16 --rotated_bbox --norm_reg_targets --centerness_on_reg \\
        --center_sampling_radius 1.5 --iou_loss_type iou --features_path data \\
        --boxes_path data --dataset_split data/split.npz --save_path out \\
        --resolution 160 --batch_size 2 --num_epochs 1
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
from nerf_rpn_tpu_torch.models.fcos import FCOSConfig
from nerf_rpn_tpu_torch.models.nerf_rpn import FCOSOverNeRF, init_params
from nerf_rpn_tpu_torch.parallel import ddp
from nerf_rpn_tpu_torch.train import checkpoint as ckpt_lib
from nerf_rpn_tpu_torch.train.state import TrainState
from nerf_rpn_tpu_torch.train.steps import (make_fcos_eval_step,
                                               make_fcos_train_step)

STRIDES = (4, 8, 16, 32)
BENCH_SHAPE = (160, 160, 160)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train, eval and benchmark NeRF RPN with FCOS (PyTorch + CUDA port).")
    p.add_argument("--mode", default="train", choices=["train", "eval", "benchmark"])
    p.add_argument("--dataset", "--dataset_name", dest="dataset_name", default="hypersim",
                   choices=["hypersim", "front3d", "general", "scannet"])
    p.add_argument("--features_path", default="")
    p.add_argument("--boxes_path", default="")
    p.add_argument("--save_path", default="")
    p.add_argument("--dataset_split", default="")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--load_backbone_only", action="store_true")
    p.add_argument("--preload", action="store_true")
    p.add_argument("--train_csv", default="")
    p.add_argument("--val_csv", default="")
    p.add_argument("--test_csv", default="")
    p.add_argument("--backbone_type", default="swin_s",
                   choices=["resnet", "resnet_tiny", "vgg_AF", "vgg_EF",
                            "swin_t", "swin_s", "swin_b", "swin_l"])
    p.add_argument("--input_dim", type=int, default=4)
    p.add_argument("--rotated_bbox", action="store_true")
    p.add_argument("--resolution", type=int, default=160)
    p.add_argument("--normalize_density", action="store_true")
    p.add_argument("--output_proposals", action="store_true")
    p.add_argument("--save_level_index", action="store_true")
    p.add_argument("--filter", choices=["none", "tp", "fp"], default="none")
    p.add_argument("--filter_threshold", type=float, default=0.7)
    p.add_argument("--output_voxel_scores", action="store_true")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--reg_loss_weight", type=float, default=1.0)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--clip_grad_norm", type=float, default=0.1)
    p.add_argument("--log_interval", type=int, default=20)
    p.add_argument("--log_to_file", action="store_true")
    p.add_argument("--eval_interval", type=int, default=1)
    p.add_argument("--keep_checkpoints", type=int, default=1)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--rotate_prob", type=float, default=0.5)
    p.add_argument("--flip_prob", type=float, default=0.5)
    p.add_argument("--rot_scale_prob", type=float, default=0.5)
    p.add_argument("--gpus", default="",
                   help="GPUs to train on, one rank each: 0-3 or 0,1,2,3 (NCCL).")
    p.add_argument("--num_convs", type=int, default=4)
    p.add_argument("--norm_reg_targets", action="store_true")
    p.add_argument("--centerness_on_reg", action="store_true")
    p.add_argument("--center_sampling_radius", type=float, default=1.5)
    p.add_argument("--iou_loss_type", default="iou",
                   choices=["iou", "linear_iou", "giou", "diou", "smooth_l1"])
    p.add_argument("--use_additional_l1_loss", action="store_true")
    p.add_argument("--conv_at_start", action="store_true",
                   help="Accepted as the JAX driver accepts it; no module reads it.")
    p.add_argument("--proj2d_loss_weight", type=float, default=0.0)
    p.add_argument("--pre_nms_top_n", type=int, default=2500)
    p.add_argument("--fpn_post_nms_top_n", type=int, default=2500)
    p.add_argument("--nms_thresh", type=float, default=0.3)
    p.add_argument("--pre_nms_thresh", type=float, default=0.0)
    p.add_argument("--min_size", type=float, default=0.0)
    p.add_argument("--ap_top_n", type=int, default=None)
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
        self.logger = common.setup_logger(args.save_path, args.log_to_file, "run_fcos_torch",
                                          ddp.rank())
        self.device = resolve_device(args.device)
        self.dtype = torch.bfloat16 if args.bf16 else torch.float32
        if self.device.type == "cuda" and not args.bf16:
            # f32 means f32: no TF32 in cuDNN convolutions or matmuls
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        side = round_up(args.resolution, args.pad_multiple)
        self.mesh_shape = (side, side, side)
        self.box_dim = 7 if args.rotated_bbox else 6
        self.model = FCOSOverNeRF(args.backbone_type, args.num_convs, args.rotated_bbox,
                                  args.norm_reg_targets, args.centerness_on_reg, STRIDES,
                                  self.dtype, resolution=args.resolution)
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
        self.cfg = FCOSConfig(
            rotated=args.rotated_bbox, fpn_strides=STRIDES,
            center_sampling_radius=args.center_sampling_radius,
            iou_loss_type=args.iou_loss_type, norm_reg_targets=args.norm_reg_targets,
            use_additional_l1_loss=args.use_additional_l1_loss,
            proj2d_loss_weight=args.proj2d_loss_weight,
            pre_nms_thresh=args.pre_nms_thresh, pre_nms_top_n=args.pre_nms_top_n,
            nms_thresh=args.nms_thresh, fpn_post_nms_top_n=args.fpn_post_nms_top_n,
            min_size=args.min_size)
        self.state = None

    def eval_step(self, mesh_shape):
        return make_fcos_eval_step(self.model, self.cfg, mesh_shape, device=self.device)

    def batches(self, dataset, shuffle: bool, seed: int = 0):
        """Train (``shuffle``): this rank's share of the global batch;
        eval: whole batches, on rank 0 alone."""
        world = ddp.world() if shuffle else 1
        it = batch_iterator(
            dataset, common.local_batch_size(self.args.batch_size, world), shuffle=shuffle,
            seed=seed, drop_last=shuffle, process_index=ddp.rank() if shuffle else 0,
            process_count=world,
            pad_multiple=self.args.pad_multiple, max_gt=self.args.max_gt,
            box_dim=self.box_dim, fixed_shape=self.mesh_shape,
            num_workers=self.args.num_workers)
        return prefetch_iterator(it, depth=self.args.prefetch_batches)

    # -- train --------------------------------------------------------------

    def train_loop(self) -> list[dict[str, float]]:
        """Returns the logged metrics (one dict per log line)."""
        args = self.args
        train_set, val_set, _ = common.build_datasets(args, "train", augment=True)
        self.logger.info(
            f"Loaded {len(train_set)} training scenes, {len(val_set)} validation scenes")
        steps_per_epoch = max(1, len(train_set) // args.batch_size)
        self.state = TrainState(self.model, args.lr, args.num_epochs * steps_per_epoch,
                                args.weight_decay, args.clip_grad_norm)
        train_step = make_fcos_train_step(self.model, self.cfg, self.mesh_shape,
                                          device=self.device)
        os.makedirs(args.save_path, exist_ok=True)
        drop_gen = torch.Generator(self.device).manual_seed(ddp.seed_for_rank(args.seed))
        best_metric, logged = None, []
        for epoch in range(1, args.num_epochs + 1):
            for i, batch in enumerate(self.batches(train_set, True, seed=epoch)):
                t0 = time.perf_counter()
                batch = common.device_batch(batch, self.device, self.dtype)
                metrics = train_step(self.state, batch, drop_gen)
                if i % args.log_interval == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    logged.append(dict(metrics, epoch=epoch, iter=i))
                    self.logger.info(
                        f"Epoch {epoch} [{i}] loss {metrics['loss']:.4f} "
                        f"cls {metrics['loss_cls']:.4f} reg {metrics['loss_reg']:.4f} "
                        f"ctr {metrics['loss_centerness']:.4f} "
                        f"grad_norm {metrics['grad_norm']:.4f} "
                        f"({time.perf_counter() - t0:.2f}s/it)")
                    if metrics["dropped_positives"] > 0:
                        self.logger.warning(
                            f"Epoch {epoch} [{i}]: the box loss dropped "
                            f"{metrics['dropped_positives']:.0f} positive locations beyond "
                            f"its capacity of 128 a gt box (center_sampling_radius "
                            f"{args.center_sampling_radius})")
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

    def eval(self, dataset, write_json: bool = True):
        args = self.args
        eval_step = self.eval_step(self.mesh_shape)
        proposals_list, scores_list, levels_list = [], [], []
        gt_boxes_list, scenes_list = [], []
        for batch in self.batches(dataset, False):
            names, gt_mask = batch["names"], batch["gt_mask"]
            grids = torch.from_numpy(batch["grids"]).to(self.device, self.dtype)
            ori = torch.from_numpy(batch["ori_sizes"]).to(self.device)
            out = eval_step(grids, ori)
            host = {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
                    for k, v in out.items() if k != "voxel_scores"}
            props, scs, lvls = common.unmask_proposals(host, self.box_dim)
            proposals_list.extend(props)
            scores_list.extend(scs)
            levels_list.extend(lvls)
            scenes_list.extend(names)
            for i in range(len(names)):
                gt_boxes_list.append(
                    batch["gt_boxes"][i][gt_mask[i]][:, :self.box_dim].astype(np.float32))
            if args.output_voxel_scores:
                for i, name in enumerate(names):
                    common.output_voxel_scores_npz(
                        args.save_path, name,
                        [v[i].float().cpu().numpy() for v in out["voxel_scores"]],
                        batch["ori_sizes"][i], STRIDES)
        if args.output_proposals:
            common.output_proposals_npz(
                args.save_path, scenes_list, proposals_list, scores_list, gt_boxes_list,
                args.filter, args.filter_threshold,
                level_indices=levels_list if args.save_level_index else None)
        if not any(len(g) for g in gt_boxes_list):
            return None, None
        return common.report_metrics(
            proposals_list, scores_list, gt_boxes_list, args, self.logger,
            args.fpn_post_nms_top_n, write_json=write_json)

    # -- benchmark ----------------------------------------------------------

    def benchmark(self, reps=300, warmup=10) -> dict[str, float]:
        """Reference protocol (``run_fcos.py:537-560``): a random 160^3 grid
        padded to ``--pad_multiple``; mean device ms a scene over ``reps``
        eval steps after ``warmup``, split into forward and propose."""
        if self.device.type != "cuda":
            raise RuntimeError("--mode benchmark times the GPU; it needs --device cuda")
        shape = tuple(round_up(s, self.args.pad_multiple) for s in BENCH_SHAPE)
        eval_step = self.eval_step(shape)
        rng = np.random.default_rng(self.args.seed)
        grids = torch.from_numpy(
            rng.standard_normal((1, *shape, 4), np.float32)).to(self.device, self.dtype)
        ori = torch.tensor([BENCH_SHAPE], dtype=torch.int32, device=self.device)

        def forward():
            cls_f, reg_f, ctr_f, _ = eval_step.forward(grids)
            return cls_f, reg_f, ctr_f, ori

        res = common.benchmark_eval_step(forward, eval_step.propose, reps, warmup,
                                         self.logger, self.device)
        return dict(res, shape=shape)


def main(argv=None):
    return ddp.run_driver(_run, parse_args(argv))


def _run(args):
    trainer = Trainer(args)
    if args.mode == "train":
        return trainer.train_loop()
    if args.mode == "eval":
        return common.eval_datasets(args, trainer.eval)
    return trainer.benchmark()


if __name__ == "__main__":
    main()
