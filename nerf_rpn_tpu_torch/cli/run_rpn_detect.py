"""RCNN objectness second stage, torch port: ``--mode train | eval``.

Port of ``nerf_rpn_tpu/cli/run_rpn_detect.py`` with its flags: the RoIs of
a stage-1 run (``--rois_path``: per scene ``proposals`` and
``level_indices``, as ``run_rpn --save_results`` writes them) are pooled
from the FPN levels (``ops/roi_align``) and scored and refined by the RCNN
head (``models/detector.py``).  The levels come from ``--features_path``
files (``level_features``, ``run_rpn --save_results``) or, with
``--fine_tune``, from a backbone trained with the head on the raw grids
(``--backbone_type``; ``swin`` is Swin-S), whose weights ``--pretrained``
takes from a stage-1 checkpoint of the port (``run_rpn``'s
``model_best``).  Boxes are AABBs, or OBBs with ``--rotated_bbox`` (the
rotated coder).  Plus:

- ``--device``: ``cuda`` (the default) or ``cpu``.  Without a GPU the
  default raises; the CPU runs only when asked for with ``--device cpu``.

``--mode train``: RoIs sampled ``--cls_batch_size / --batch_size`` a scene
(``--fg_fraction``, ``--fg_threshold``, ``--bg_threshold``), the
cross-entropy plus ``--reg_loss_weight`` x smooth-L1 (``--obj_only``: the
cross-entropy alone), AdamW with optax's one-cycle schedule and clip, the
batch order of ``np.random.default_rng(epoch)`` with the ragged batch
dropped, fine-tune augmentation of grids and boxes together, a validation
eval every ``--eval_interval`` epochs, ``epoch_N`` and ``model_best`` (by
classification accuracy) checkpoints, pruned to ``--keep_checkpoints``.
``--mode eval``: every RoI scored, the refined boxes filtered (clip or the
OBB centre mask, small boxes, ``--filter_score_threhold``, NMS at
``--nms_thresh``, the ``--filter_num_threhold`` cap), classification
precision / accuracy / precision@100 over all valid RoIs, AP@25 and AP@50
over the filtered, ranked boxes, ``eval.json`` with the JAX driver's keys
and, with ``--output_proposals``, the proposals npz.  ``--checkpoint``
loads a checkpoint of this driver (or a JAX ``.msgpack`` of the RCNN state)
for either mode; ``--pretrained`` also takes a stage-1 ``.msgpack``.

Differences from the JAX driver: a ``--pretrained`` file that does not
load raises (the JAX driver logs a warning and trains on a random
backbone), and ``--pretrained`` without ``--fine_tune`` is refused (the
JAX driver ignores it).  ``--use_cuda`` is accepted and ignored, as in
JAX.  Not ported yet: ``--wandb``.

``--gpus`` trains data parallel as ``run_rpn`` does (``parallel/ddp.py``):
each rank takes its share of the global batch's order, a rank's batch is
padded to the largest grid (or level) over the ranks, which is the shape
one process pads the global batch to, and the RoIs a scene stay
``--cls_batch_size / --batch_size``.  The eval (the validation eval, and
``--mode eval`` over ``--gpus``) splits each padded batch over the ranks
by scene; rank 0 gathers the results, writes the report and the
checkpoints.

Example (``scripts/train_rcnn.sh``'s configuration)::

    python -m nerf_rpn_tpu_torch.cli.run_rpn_detect --mode train --fine_tune \\
        --backbone_type swin --rotated_bbox --resolution 200 \\
        --features_path data --boxes_path data --rois_path rpn/results/proposals \\
        --dataset_split data/split.npz --pretrained rpn/model_best --save_path rcnn \\
        --output_size 3 3 3 --is_add_layer --is_flatten --cls_batch_size 256 \\
        --batch_size 2 --fg_threshold 0.25 --bg_threshold 0.25
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time

import numpy as np
import torch

from nerf_rpn_tpu_torch.cli import common
from nerf_rpn_tpu_torch.data.datasets import (RPNClassificationDataset, batch_iterator,
                                               collate_classification_batch, load_split)
from nerf_rpn_tpu_torch.data.loader import prefetch_iterator
from nerf_rpn_tpu_torch.device import resolve_device
from nerf_rpn_tpu_torch.evaluation.metrics import (evaluate_box_proposals_ap,
                                                    evaluate_classification)
from nerf_rpn_tpu_torch.models.detector import RCNNConfig, RCNNDetector, RCNNHead
from nerf_rpn_tpu_torch.models.nerf_rpn import build_backbone, init_params
from nerf_rpn_tpu_torch.ops.roi_align import map_rois_to_levels_np
from nerf_rpn_tpu_torch.parallel import ddp
from nerf_rpn_tpu_torch.train import checkpoint as ckpt_lib
from nerf_rpn_tpu_torch.train.state import TrainState
from nerf_rpn_tpu_torch.train.steps import (make_rcnn_eval_step, make_rcnn_filter_step,
                                               make_rcnn_train_step)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="RCNN second stage (PyTorch + CUDA port).")
    p.add_argument("--mode", default="train", choices=["train", "eval"])
    p.add_argument("--features_path", default="")
    p.add_argument("--boxes_path", default="")
    p.add_argument("--rois_path", default="")
    p.add_argument("--save_root", default="")
    p.add_argument("--save_path", default="")
    p.add_argument("--dataset_split", default="")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--pretrained", default="",
                   help="Stage-1 checkpoint whose backbone --fine_tune starts from.")
    p.add_argument("--fine_tune", action="store_true")
    p.add_argument("--backbone_type", default="resnet",
                   choices=["resnet", "resnet_tiny", "vgg_AF", "vgg_EF", "swin"])
    p.add_argument("--backbone_input_dim", type=int, default=4)
    p.add_argument("--resolution", type=int, default=160)
    p.add_argument("--normalize_density", action="store_true")
    p.add_argument("--output_proposals", action="store_true")
    p.add_argument("--filter", choices=["none", "tp", "fp"], default="none")
    p.add_argument("--filter_threshold", type=float, default=0.5)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--reg_loss_weight", type=float, default=5.0)
    p.add_argument("--weight_decay", type=float, default=0.0005)
    p.add_argument("--clip_grad_norm", type=float, default=0.1)
    p.add_argument("--rotate_prob", type=float, default=0.5)
    p.add_argument("--flip_prob", type=float, default=0.5)
    p.add_argument("--rot_scale_prob", type=float, default=0.5)
    p.add_argument("--log_interval", type=int, default=20)
    p.add_argument("--eval_interval", type=int, default=1)
    p.add_argument("--keep_checkpoints", type=int, default=1)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--gpus", default="",
                   help="GPUs to train or evaluate on, one rank each: 0-3 or 0,1,2,3 (NCCL).")
    p.add_argument("--n_classes", type=int, default=2)
    p.add_argument("--output_size", nargs="+", type=int, default=[4, 4, 4])
    p.add_argument("--spatial_scale", nargs="+", type=int, default=[4, 8, 16, 32])
    p.add_argument("--feature_input_dim", type=int, default=256)
    p.add_argument("--obj_only", action="store_true")
    p.add_argument("--enlarge_scale", type=float, default=0.2)
    p.add_argument("--use_cuda", action="store_true", help="Accepted and ignored.")
    p.add_argument("--remap", action="store_true")
    p.add_argument("--is_add_layer", action="store_true")
    p.add_argument("--feature_extracting_type", default="pooling",
                   choices=["pooling", "interpolation"])
    p.add_argument("--nms_thresh", type=float, default=0.1)
    p.add_argument("--filter_score_threhold", type=float, default=0.5)
    p.add_argument("--filter_num_threhold", type=float, default=300)
    p.add_argument("--cls_batch_size", type=int, default=512)
    p.add_argument("--fg_fraction", type=float, default=0.5)
    p.add_argument("--fg_threshold", type=float, default=0.35)
    p.add_argument("--bg_threshold", type=float, default=0.15)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--rotated_bbox", action="store_true")
    p.add_argument("--is_flatten", action="store_true")
    p.add_argument("--log_to_file", action="store_true")
    p.add_argument("--output_all", action="store_true")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute path.")
    p.add_argument("--max_rois", type=int, default=1024)
    p.add_argument("--max_gt", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=4,
                   help="Sample-loading threads; 0 = load in-line.")
    p.add_argument("--prefetch_batches", type=int, default=2,
                   help="Batches assembled ahead of the step; 0 disables "
                        "background prefetch.")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) | cpu.")
    args = p.parse_args(argv)
    if args.wandb:
        raise NotImplementedError("--wandb is not ported to torch (ROADMAP.md)")
    ddp.parse_gpus(args.gpus)
    if args.pretrained and not args.fine_tune:
        raise ValueError("--pretrained loads the backbone of --fine_tune; without it the "
                         "model has no backbone to load")
    return args


class Trainer:
    """Holds the model, its device and the steps of one CLI run."""

    def __init__(self, args):
        self.args = args
        if args.save_root and not args.save_path:
            args.save_path = os.path.join(args.save_root, "rcnn")
        self.logger = common.setup_logger(args.save_path, args.log_to_file,
                                          "run_rpn_detect_torch", ddp.rank())
        self.device = resolve_device(args.device)
        self.dtype = torch.bfloat16 if args.bf16 else torch.float32
        if self.device.type == "cuda" and not args.bf16:
            # f32 means f32: no TF32 in cuDNN convolutions or matmuls
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.box_dim = 7 if args.rotated_bbox else 6
        self.cfg = RCNNConfig(
            rotated=args.rotated_bbox,
            batch_size=args.cls_batch_size,
            fg_fraction=args.fg_fraction,
            fg_threshold=args.fg_threshold,
            bg_threshold=args.bg_threshold,
            output_size=tuple(args.output_size),
            enlarge_scale=args.enlarge_scale,
            pool_mode="avg" if args.feature_extracting_type == "interpolation" else "max",
            remap_levels=args.remap,
        )
        head = RCNNHead(args.feature_input_dim, args.n_classes, args.rotated_bbox,
                        args.is_add_layer, args.is_flatten, self.cfg.output_size, self.dtype)
        backbone = None
        if args.fine_tune:
            bb = "swin_s" if args.backbone_type == "swin" else args.backbone_type
            backbone = build_backbone(bb, args.resolution, self.dtype)
        self.model = RCNNDetector(head, backbone)
        init_params(self.model, torch.Generator().manual_seed(args.seed))
        if args.pretrained:
            # the backbone of a stage-1 checkpoint (reference --pretrained,
            # run_rpn_detect.py:279-300); a file that does not load raises
            ckpt_lib.restore_checkpoint(self.model, args.pretrained, backbone_only=True)
            self.logger.info(f"Loaded pretrained backbone {args.pretrained}")
        if args.checkpoint:
            ckpt_lib.restore_checkpoint(self.model, args.checkpoint)
            self.logger.info(f"Loaded checkpoint {args.checkpoint}")
        self.model.to(self.device).eval()
        ddp.broadcast_module_(self.model)
        self.spatial_scales = tuple(args.spatial_scale)
        self.state = None

    def dataset(self, scenes, augment=False):
        """``augment``: the fine-tune train set only (the reference passes
        the rotate / flip / rot_scale probabilities to the train dataset
        alone, ``run_rpn_detect.py:280-285``)."""
        a = self.args
        return RPNClassificationDataset(
            a.features_path, a.boxes_path, a.rois_path,
            scene_names=scenes, fine_tune=a.fine_tune,
            normalize_density=a.normalize_density,
            flip_prob=a.flip_prob if augment else 0.0,
            rotate_prob=a.rotate_prob if augment else 0.0,
            rot_scale_prob=a.rot_scale_prob if augment else 0.0,
            seed=a.seed)

    def _collate(self, samples):
        batch = collate_classification_batch(samples, max_rois=self.args.max_rois,
                                             max_gt=self.args.max_gt, box_dim=self.box_dim)
        if self.args.remap:
            n = len(self.spatial_scales)
            batch["roi_levels"] = map_rois_to_levels_np(
                batch["rois"], 0, n - 1, canonical_scale=self.cfg.canonical_scale,
                canonical_level=self.cfg.canonical_level)
        return batch

    def device_batch(self, batch: dict) -> dict:
        """Host batch -> the steps' device tensors: the grids in the compute
        dtype, saved FPN levels in f32 (as the JAX driver feeds them)."""
        out = {k: torch.from_numpy(batch[k]).to(self.device)
               for k in ("rois", "roi_levels", "roi_valid", "gt_boxes", "gt_mask")}
        if "grids" in batch:
            out["grids"] = torch.from_numpy(batch["grids"]).to(self.device, self.dtype)
        else:
            out["features"] = [torch.from_numpy(f).to(self.device) for f in batch["features"]]
        return out

    def batches(self, dataset, shuffle=False, seed=0):
        """(host batch, number of real scenes) in the JAX driver's order:
        ``default_rng(seed)`` shuffles; train (shuffle) drops the ragged
        last batch and takes this rank's share of the order (the JAX
        driver's ``DistributedSampler`` wrap); eval pads the last batch
        with the last scene and takes this rank's block of each batch
        (``ddp.eval_blocks``).  Loading runs in ``--num_workers`` threads,
        ``--prefetch_batches`` batches ahead."""
        if shuffle:
            world = ddp.world()
            bs = common.local_batch_size(self.args.batch_size, world)
            it = batch_iterator(dataset, bs, shuffle=True, seed=seed, drop_last=True,
                                process_index=ddp.rank(), process_count=world,
                                num_workers=self.args.num_workers, collate=self._collate)
            blocks = itertools.repeat((None, bs))
        else:
            blocks = ddp.eval_blocks(len(dataset), self.args.batch_size, pad_last=True)
            it = batch_iterator(dataset, self.args.batch_size,
                                index_batches=[idx for idx, _ in blocks],
                                num_workers=self.args.num_workers, collate=self._collate)
        return prefetch_iterator(((host, n_real) for host, (_, n_real) in zip(it, blocks)),
                                 depth=self.args.prefetch_batches)

    @staticmethod
    def pad_to_global(host: dict) -> dict:
        """A rank's batch padded to the largest grid (fine-tune) or level
        shapes over the ranks: the shape that one process's collate gives
        the global batch (its largest scene, rounded up to 8).  At world 1
        the batch as it is."""
        if ddp.world() == 1:
            return host
        key = "grids" if "grids" in host else "features"
        arrays = [host["grids"]] if key == "grids" else host["features"]
        target = ddp.all_reduce_max(np.array([a.shape[1:4] for a in arrays]))
        padded = [np.pad(a, [(0, 0), *[(0, t - n) for n, t in zip(a.shape[1:4], tgt)], (0, 0)])
                  for a, tgt in zip(arrays, target)]
        return dict(host, **{key: padded[0] if key == "grids" else padded})

    # -- train --------------------------------------------------------------

    def train_loop(self) -> list[dict[str, float]]:
        """Returns the logged metrics (one dict per log line)."""
        args = self.args
        train_scenes, val_scenes, _ = load_split(args.dataset_split)
        train_set = self.dataset(train_scenes, augment=args.fine_tune)
        val_set = self.dataset(val_scenes)
        self.logger.info(f"{len(train_set)} train / {len(val_set)} val scenes")
        # the global batch's: the step count, and the RoIs sampled a scene
        steps = max(1, len(train_set) // args.batch_size) * args.num_epochs
        self.state = TrainState(self.model, args.lr, steps, args.weight_decay,
                                args.clip_grad_norm)
        rois_per_image = max(1, args.cls_batch_size // args.batch_size)
        train_step = make_rcnn_train_step(self.model, self.cfg, self.spatial_scales,
                                          rois_per_image, reg_loss_weight=args.reg_loss_weight,
                                          obj_only=args.obj_only)
        os.makedirs(args.save_path, exist_ok=True)
        # separate streams for RoI sampling and stochastic depth
        seed = ddp.seed_for_rank(args.seed)
        gen = torch.Generator(self.device).manual_seed(seed)
        drop_gen = torch.Generator(self.device).manual_seed(seed + 1)
        best, logged = None, []
        for epoch in range(1, args.num_epochs + 1):
            for i, (host, _) in enumerate(self.batches(train_set, True, seed=epoch)):
                t0 = time.perf_counter()
                batch = self.device_batch(self.pad_to_global(host))
                metrics = train_step(self.state, batch, gen, drop_gen)
                if i % args.log_interval == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    logged.append(dict(m, epoch=epoch, iter=i))
                    self.logger.info(
                        f"Epoch {epoch} [{i}] loss {m['loss']:.4f} "
                        f"obj {m['loss_objectness']:.4f} reg {m['loss_rpn_box_reg']:.4f} "
                        f"fg/bg rois {m['fg_rois']:.0f}/{m['bg_rois']:.0f} "
                        f"grad_norm {m['grad_norm']:.4f} ({time.perf_counter() - t0:.2f}s/it)")
            evaluate = epoch % args.eval_interval == 0 or epoch == args.num_epochs
            # every rank evaluates its share of the validation scenes
            report = self.eval(val_set) if evaluate else None
            if ddp.is_main() and evaluate:
                metric = report["classification"]["accuracy"]
                if best is None or metric > best:
                    best = metric
                    ckpt_lib.save_checkpoint(
                        self.state, os.path.join(args.save_path, "model_best"), vars(args),
                        epoch)
                ckpt_lib.save_checkpoint(
                    self.state, os.path.join(args.save_path, f"epoch_{epoch}"), vars(args),
                    epoch)
                ckpt_lib.delete_old_checkpoints(args.save_path, args.keep_checkpoints)
            ddp.barrier()
        return logged

    # -- eval ---------------------------------------------------------------

    def eval(self, dataset) -> dict | None:
        """Scores, filters and reports ``dataset``, split over the ranks by
        scene (``ddp.eval_blocks``); rank 0 gathers the scenes' results in
        order, writes ``eval.json`` and ``--output_proposals`` and returns
        the contents of ``eval.json`` (``ap_25``, ``ap_50``,
        ``classification``), the other ranks None."""
        args = self.args
        eval_step = make_rcnn_eval_step(self.model, self.cfg, self.spatial_scales)
        # the refined proposals are filtered before AP and output (reference
        # filter_proposals, applied at run_rpn_detect.py:495-497)
        filter_step = make_rcnn_filter_step(self.cfg, args.filter_score_threhold,
                                            args.nms_thresh, int(args.filter_num_threhold))
        scenes = []  # (index, scores, labels, refined boxes, their scores, gt, name)
        blocks = ddp.eval_blocks(len(dataset), args.batch_size, pad_last=True)
        for (idx, _), (host, n_real) in zip(blocks, self.batches(dataset)):
            out = eval_step(self.device_batch(host))
            # the clip's "mesh size": the level-0 feature shape times the
            # first scale (the grid shape times it in fine-tune, which
            # reproduces the reference's sizes there, run_rpn_detect.py:495)
            mesh_sizes = torch.from_numpy(
                (host["feat_shapes"] * self.spatial_scales[0]).astype(np.float32)).to(self.device)
            fboxes, keep, order = filter_step(out["refined_boxes"], out["scores"], out["valid"],
                                              mesh_sizes)
            # float32 at the host boundary (bf16 breaks plain-numpy readers)
            probs = out["scores"].float().cpu().numpy()
            labels = out["labels"].cpu().numpy()
            valid = out["valid"].cpu().numpy()
            fboxes = fboxes.float().cpu().numpy()
            keep, order = keep.cpu().numpy(), order.cpu().numpy()
            for i in range(n_real):
                v = valid[i]
                # classification over all valid RoIs (unfiltered); AP over
                # the filtered set, by descending score
                ranked = order[i][keep[i][order[i]]]
                scenes.append((int(idx[i]), probs[i][v][:, 1], labels[i][v].astype(np.int32),
                               fboxes[i][ranked][:, :self.box_dim], probs[i][ranked][:, 1],
                               host["gt_boxes"][i][host["gt_mask"][i]], host["names"][i]))
        columns = ddp.gather_scenes(scenes, 6)
        if columns is None:
            return None
        scores_list, labels_list, refined_list, filt_scores_list, gt_list, names = columns
        cls = evaluate_classification(scores_list, labels_list, 0.5)
        self.logger.info(
            f"cls precision {cls['precision']:.4f} accuracy {cls['accuracy']:.4f} "
            f"precision@100 {cls['precision_100']:.4f}")
        ap25 = evaluate_box_proposals_ap(refined_list, filt_scores_list, gt_list, 0.25,
                                         args.top_k)
        ap50 = evaluate_box_proposals_ap(refined_list, filt_scores_list, gt_list, 0.5,
                                         args.top_k)
        self.logger.info(f"AP@25 {ap25['ap']:.4f}  AP@50 {ap50['ap']:.4f}")
        clean = {k: {kk: (vv.tolist() if isinstance(vv, np.ndarray) else vv)
                     for kk, vv in v.items()}
                 for k, v in (("ap_25", ap25), ("ap_50", ap50))}
        clean["classification"] = {k: float(v) for k, v in cls.items()}
        if args.save_path:
            os.makedirs(args.save_path, exist_ok=True)
            with open(os.path.join(args.save_path, "eval.json"), "w") as f:
                json.dump(clean, f, indent=2)
        if args.output_proposals:
            common.output_proposals_npz(args.save_path, names, refined_list, filt_scores_list,
                                        gt_list, args.filter, args.filter_threshold)
        return clean


def main(argv=None):
    return ddp.run_driver(_run, parse_args(argv))


def _run(args):
    trainer = Trainer(args)
    if args.mode == "train":
        return trainer.train_loop()
    _, _, test_scenes = load_split(args.dataset_split)
    return trainer.eval(trainer.dataset(test_scenes))


if __name__ == "__main__":
    main()
