"""Checkpoints in the reference's ``torch.save`` layout (port of
``nerf_rpn_tpu/train/checkpoint.py``).

A checkpoint is one file holding ``{epoch, backbone_state_dict,
rpn_head_state_dict, train_args}`` -- the reference CLI's layout; an FCOS
model's head goes under ``fcos_state_dict`` with its keys prefixed
``head.``, as the reference FCOS CLI saves its ``FCOSModule`` -- plus
``optimizer_state_dict``, ``scheduler_state_dict`` and ``step``, with a
``<path>.args.json`` sidecar of the run's arguments.  The train loop writes
``epoch_N`` every evaluated epoch and ``model_best`` when the validation
recall (RCNN: classification accuracy) improves; ``delete_old_checkpoints`` keeps the newest
``--keep_checkpoints`` ``epoch_*`` files by mtime.  Orbax directories and
``.msgpack`` files of the JAX package are not read.
"""

from __future__ import annotations

import glob
import json
import os

import torch


def _split(model: torch.nn.Module, part: str) -> dict[str, torch.Tensor]:
    prefix = part + "."
    return {k[len(prefix):]: v.detach().cpu() for k, v in model.state_dict().items()
            if k.startswith(prefix)}


def _head_entry(model: torch.nn.Module) -> tuple[str, str, str]:
    """(head module, checkpoint key, key prefix) of the model's head."""
    if hasattr(model, "fcos_head"):
        return "fcos_head", "fcos_state_dict", "head."
    if hasattr(model, "rpn_head"):
        return "rpn_head", "rpn_head_state_dict", ""
    return "head", "rcnn_state_dict", ""


def save_checkpoint(state, path: str, train_args: dict | None = None,
                    epoch: int | None = None) -> None:
    """Write ``state`` (a ``TrainState``) to ``path`` and its args sidecar."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    head, key, prefix = _head_entry(state.model)
    payload = {
        "epoch": epoch,
        "backbone_state_dict": _split(state.model, "backbone"),
        key: {prefix + k: v for k, v in _split(state.model, head).items()},
        "train_args": train_args,
        "optimizer_state_dict": state.optimizer.state_dict(),
        "scheduler_state_dict": state.scheduler.state_dict(),
        "step": state.step,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if train_args is not None:
        with open(path + ".args.json", "w") as f:
            json.dump({k: str(v) for k, v in train_args.items()}, f, indent=2)


def restore_checkpoint(model: torch.nn.Module, path: str, backbone_only: bool = False) -> dict:
    """Load the weights of ``path`` into ``model``; with ``backbone_only``
    only the backbone (the reference's ``--load_backbone_only``, and the
    RCNN driver's ``--pretrained`` from a stage-1 checkpoint).  Strict: a
    missing or mismatched key raises.  The optimizer state stays unread, as
    the JAX CLI restores with ``load_opt_state=False``.  Returns the
    checkpoint dict."""
    ckpt = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if model.backbone is not None:
        model.backbone.load_state_dict(ckpt["backbone_state_dict"], strict=True)
    elif backbone_only or ckpt["backbone_state_dict"]:
        raise ValueError(f"{path} holds a backbone and the model has none")
    if not backbone_only:
        head, key, prefix = _head_entry(model)
        getattr(model, head).load_state_dict(
            {k[len(prefix):]: v for k, v in ckpt[key].items() if k.startswith(prefix)},
            strict=True)
    return ckpt


def delete_old_checkpoints(save_path: str, keep_latest: int = 5) -> None:
    """Remove all but the newest ``keep_latest`` ``epoch_*`` checkpoints
    (by mtime) and their sidecars; ``keep_latest <= 0`` removes them all."""
    ckpts = sorted((c for c in glob.glob(os.path.join(save_path, "epoch_*"))
                    if os.path.isfile(c) and not c.endswith(".args.json")),
                   key=os.path.getmtime)
    for c in ckpts[:-keep_latest] if keep_latest > 0 else ckpts:
        os.remove(c)
        if os.path.isfile(c + ".args.json"):
            os.remove(c + ".args.json")
