"""Checkpoints in the reference's ``torch.save`` layout, and the JAX
package's ``.msgpack`` files (port of ``nerf_rpn_tpu/train/checkpoint.py``).

A checkpoint is one file holding ``{epoch, backbone_state_dict,
rpn_head_state_dict, train_args}`` -- the reference CLI's layout; an FCOS
model's head goes under ``fcos_state_dict`` with its keys prefixed
``head.``, as the reference FCOS CLI saves its ``FCOSModule`` -- plus
``optimizer_state_dict``, ``scheduler_state_dict``, ``step`` and
``anchor_order``, with a ``<path>.args.json`` sidecar of the run's
arguments.  The train loop writes ``epoch_N`` every evaluated epoch and
``model_best`` when the validation recall (RCNN: classification accuracy)
improves; ``delete_old_checkpoints`` keeps the newest ``--keep_checkpoints``
``epoch_*`` files by mtime.

Anchor order: the RPN head's output channels come a group per anchor
(1 logit, 6 or 8 deltas).  This package orders a level's 13 anchors as the
JAX package does (insertion-order dedup of the ratio permutations); the
reference orders them by ``set(permutations(r))``.  So a file that this
package writes says ``anchor_order: "port"``, and an anchor-RPN file
without it -- a released reference checkpoint -- has its head's channels
taken from the reference's order (``models/anchors.anchor_permutation``),
as the JAX package's ``tools/convert_weights.py`` does.

``.msgpack``: the flax variables ``{"params": ..., "batch_stats": ...}`` that
``nerf_rpn_tpu.tools.convert_weights`` (or this package's copy) writes and
the JAX drivers' ``--checkpoint`` / ``--pretrained`` read, decoded without
flax (``train/flax_msgpack.py``) and mapped by ``weights.from_jax_params`` /
``rcnn_from_jax_params``; their head channels are in the JAX order already.
Orbax directories (the JAX package's ``save_checkpoint``) are refused with
the command that exports one to ``.msgpack``.  Optimizer state is not read
from any format, as the JAX CLI restores with ``load_opt_state=False``.
"""

from __future__ import annotations

import glob
import json
import os

import torch

from nerf_rpn_tpu_torch import weights as weights_lib
from nerf_rpn_tpu_torch.models.anchors import DEFAULT_ASPECT_RATIOS, anchor_permutation
from nerf_rpn_tpu_torch.train.flax_msgpack import read_msgpack

# the ``anchor_order`` entry of this package's files
ANCHOR_ORDER = "port"

ORBAX_EXPORT = (
    "python -c \"import sys; from flax.serialization import msgpack_serialize; "
    "from nerf_rpn_tpu.train.checkpoint import load_raw_checkpoint; "
    "open(sys.argv[2], 'wb').write(msgpack_serialize(load_raw_checkpoint(sys.argv[1])))\" "
    "<dir> <out>.msgpack")


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
        "anchor_order": ANCHOR_ORDER,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if train_args is not None:
        with open(path + ".args.json", "w") as f:
            json.dump({k: str(v) for k, v in train_args.items()}, f, indent=2)


def reference_to_port_anchors(head_sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """An anchor-RPN head's state dict with the output channels of
    ``cls_logits`` and ``bbox_pred`` (a group of 1 and of 6 or 8 an
    anchor) taken from the reference's anchor order to this package's (the
    default ratios, the only ones a flag-configured model has)."""
    perm = torch.from_numpy(anchor_permutation(DEFAULT_ASPECT_RATIOS[0]))
    a = len(perm)
    out = dict(head_sd)
    for key, t in head_sd.items():
        if key.split(".")[0] in ("cls_logits", "bbox_pred"):
            if t.shape[0] % a:
                raise ValueError(f"{key}: {t.shape[0]} output channels for {a} anchors")
            out[key] = t.reshape(a, t.shape[0] // a, *t.shape[1:])[perm].reshape(t.shape)
    return out


def _load_backbone(model: torch.nn.Module, sd: dict[str, torch.Tensor], path: str) -> None:
    if model.backbone is None:
        raise ValueError(f"{path} holds a backbone and the model has none")
    model.backbone.load_state_dict(
        {k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")},
        strict=True)


def _leaves_to_numpy(tree):
    """bf16 leaves (torch tensors) of a decoded tree -> f32 numpy."""
    if isinstance(tree, dict):
        return {k: _leaves_to_numpy(v) for k, v in tree.items()}
    return tree.float().numpy() if isinstance(tree, torch.Tensor) else tree


def _restore_msgpack(model: torch.nn.Module, path: str, backbone_only: bool) -> dict:
    """A flax variables file into ``model``: the whole model, or with
    ``backbone_only`` the ``backbone`` tree of a stage-1 file (its
    ``batch_stats`` under ``backbone``) or of an RCNN fine-tune file (the
    backbone's own ``batch_stats``)."""
    variables = read_msgpack(path)
    if not isinstance(variables, dict) or "params" not in variables:
        raise ValueError(f"{path}: not a flax variables file (no 'params')")
    params = _leaves_to_numpy(variables["params"])
    stats = _leaves_to_numpy(variables.get("batch_stats") or {})
    stage1 = "rpn_head" in params or "fcos_head" in params
    if backbone_only:
        if "backbone" not in params:
            raise ValueError(f"{path} holds no backbone")
        bb_stats = stats.get("backbone", {}) if stage1 else stats
        _load_backbone(model, weights_lib.from_jax_params(
            {"backbone": params["backbone"]}, {"backbone": bb_stats} if bb_stats else None,
            model.backbone), path)
        return variables
    if _head_entry(model)[0] == "head":  # the RCNN stage
        sd = weights_lib.rcnn_from_jax_params(params, stats, model.backbone)
    else:
        sd = weights_lib.from_jax_params(params, stats, model.backbone)
    model.load_state_dict(sd, strict=True)
    return variables


def restore_checkpoint(model: torch.nn.Module, path: str, backbone_only: bool = False) -> dict:
    """Load the weights of ``path`` -- this package's (or the reference's)
    ``torch.save`` file, or a flax ``.msgpack`` -- into ``model``; with
    ``backbone_only`` only the backbone (the reference's
    ``--load_backbone_only``, and the RCNN driver's ``--pretrained`` from a
    stage-1 checkpoint).  Strict: a missing or mismatched key raises; an
    orbax directory raises a ``ValueError`` naming its export to
    ``.msgpack``.  Returns the checkpoint dict (``.msgpack``: its tree)."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint of the JAX package, which this "
            f"package does not read.  Export it to .msgpack where the JAX package runs: "
            f"{ORBAX_EXPORT}")
    if path.endswith(".msgpack"):
        return _restore_msgpack(model, path, backbone_only)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if model.backbone is not None:
        model.backbone.load_state_dict(ckpt["backbone_state_dict"], strict=True)
    elif backbone_only or ckpt["backbone_state_dict"]:
        raise ValueError(f"{path} holds a backbone and the model has none")
    if not backbone_only:
        head, key, prefix = _head_entry(model)
        sd = {k[len(prefix):]: v for k, v in ckpt[key].items() if k.startswith(prefix)}
        if head == "rpn_head" and ckpt.get("anchor_order") != ANCHOR_ORDER:
            sd = reference_to_port_anchors(sd)
        getattr(model, head).load_state_dict(sd, strict=True)
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
