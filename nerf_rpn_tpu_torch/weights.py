"""Flax variables <-> torch ``state_dict`` for the anchor RPN, FCOS and RCNN.

The JAX package's params ``{"backbone": ..., "rpn_head": ...}`` map onto
this package's ``NeRFRPN``, and ``{"backbone": ..., "fcos_head": ...}``
onto its ``FCOSOverNeRF``, one leaf at a time:

- conv kernels (kx, ky, kz, in, out) -> weight (out, in, kx, ky, kz);
- dense kernels (in, out) -> weight (out, in);
- LayerNorm, GroupNorm and BatchNorm ``scale`` -> ``weight``; biases and
  the relative-position tables unchanged;
- the ``batch_stats`` collection's ``mean`` / ``var`` -> a BatchNorm's
  ``running_mean`` / ``running_var`` (and a ``num_batches_tracked`` of 0,
  which flax does not keep);
- the FCOS head's ``{cls,bbox}_tower_{d}_conv`` / ``_gn`` ->
  ``{cls,bbox}_tower.{3d}`` / ``.{3d+1}`` and its per-level ``scale_{l}``
  (a scalar) -> ``scales.{l}.scale`` (shape (1,)), the reference keys;
- the RCNN stage (``models/detector.RCNNDetector``): ``head/{conv_0,
  conv_1, bbox_pred, cls_score}`` -> ``head.{conv_0, conv_1, bbox_pred,
  cls_score}`` (the head takes its features channels last, so the
  flattened Dense kernel needs no row permutation) and, with
  ``--fine_tune``, ``backbone/...`` as above; the JAX RCNN state keeps a
  CNN backbone's ``batch_stats`` as the backbone's own tree and the
  features mode's params as the bare head tree
  (:func:`rcnn_from_jax_params`, :func:`rcnn_to_jax_variables`).

Module names follow the reference torch keys, so
``nerf_rpn_tpu.tools.convert_weights.convert_backbone`` applied to the
backbone part of a port ``state_dict`` gives the flax trees back.  The Swin
backbone's names map by rule; a CNN backbone (``models/resnet.py``,
``models/vgg.py``) gives its table through ``flax_names()`` -- VGG's
depends on its configuration -- so the functions take the port's
``backbone`` module (default: the Swin rules).  RPN-head channels stay in
the JAX package's anchor order.

``save_npz`` / ``load_npz`` store a flax tree flattened to ``a/b/c`` keys
(the format of ``--weights``): the params tree alone, or ``{"params":
..., "batch_stats": ...}`` for a model with BatchNorms;
``load_variables`` reads either.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# the RCNN head's modules: the same names in flax and in torch
RCNN_HEAD_MODULES = ("conv_0", "conv_1", "bbox_pred", "cls_score")


def _flax_module_to_torch(path: list[str]) -> list[str]:
    top, head, *tail = path
    if top == "backbone":
        if head == "patch_embed":
            return ["backbone", "patch_partition", "0"]
        if head == "patch_norm":
            return ["backbone", "patch_partition", "2"]
        if m := re.fullmatch(r"merge_(\d+)", head):
            return ["backbone", "stages", m[1], "0", *tail]
        if m := re.fullmatch(r"stage(\d+)_block(\d+)", head):
            i, j = int(m[1]), int(m[2])
            sub = {"mlp_fc1": ["mlp", "0"], "mlp_fc2": ["mlp", "3"]}.get(
                tail[0], tail[:1])
            return ["backbone", "stages", str(i), str(j + (i > 0)), *sub, *tail[1:]]
        if head == "fpn_neck":
            m = re.fullmatch(r"(lateral|output)_(\d+)", tail[0])
            kind = "lateral_convs" if m[1] == "lateral" else "fpn_convs"
            return ["backbone", "fpn_neck", kind, m[2]]
    elif top == "rpn_head":
        if m := re.fullmatch(r"tower_(\d+)", head):
            return ["rpn_head", "conv", str(2 * int(m[1]))]
        if head in ("cls_logits", "bbox_pred"):
            return ["rpn_head", head]
    elif top == "fcos_head":
        if m := re.fullmatch(r"(cls_tower|bbox_tower)_(\d+)_(conv|gn)", head):
            return ["fcos_head", m[1], str(3 * int(m[2]) + (m[3] == "gn"))]
        if m := re.fullmatch(r"scale_(\d+)", head):
            return ["fcos_head", "scales", m[1]]
        if head in ("cls_logits", "bbox_pred", "centerness"):
            return ["fcos_head", head]
    elif top == "head" and head in RCNN_HEAD_MODULES:
        return ["head", head]
    raise KeyError(f"no torch counterpart for flax module {'/'.join(path)}")


def _torch_module_to_flax(parts: list[str]) -> list[str]:
    top, head, *tail = parts
    if top == "backbone":
        if head == "patch_partition":
            return ["backbone", {"0": "patch_embed", "2": "patch_norm"}[tail[0]]]
        if head == "stages":
            i, k, *rest = tail
            i, k = int(i), int(k)
            if i > 0 and k == 0:
                return ["backbone", f"merge_{i}", *rest]
            if rest[0] == "mlp":
                rest = [{"0": "mlp_fc1", "3": "mlp_fc2"}[rest[1]]]
            return ["backbone", f"stage{i}_block{k - (i > 0)}", *rest]
        if head == "fpn_neck":
            kind = {"lateral_convs": "lateral", "fpn_convs": "output"}[tail[0]]
            return ["backbone", "fpn_neck", f"{kind}_{tail[1]}"]
    elif top == "rpn_head":
        if head == "conv":
            return ["rpn_head", f"tower_{int(tail[0]) // 2}"]
        return ["rpn_head", head]
    elif top == "fcos_head":
        if head in ("cls_tower", "bbox_tower"):
            d, kind = divmod(int(tail[0]), 3)
            return ["fcos_head", f"{head}_{d}_{'gn' if kind else 'conv'}"]
        if head == "scales":
            return ["fcos_head", f"scale_{tail[0]}"]
        return ["fcos_head", head]
    elif top == "head" and head in RCNN_HEAD_MODULES:
        return ["head", head]
    raise KeyError(f"no flax counterpart for torch module {'.'.join(parts)}")


def flatten_tree(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            flat.update(flatten_tree(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


def unflatten_tree(flat: dict[tuple, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _backbone_table(backbone) -> dict[str, tuple[str, ...]] | None:
    """Torch module path -> flax module path (both from the model's root)
    of a backbone that gives its table, else None (the Swin rules)."""
    if backbone is None or not hasattr(backbone, "flax_names"):
        return None
    return {f"backbone.{k}": ("backbone", *v.split("/"))
            for k, v in backbone.flax_names().items()}


def from_jax_params(params: dict, batch_stats: dict | None = None,
                    backbone=None) -> dict[str, torch.Tensor]:
    """Flax params tree (numpy leaves), and its ``batch_stats`` tree where
    the model has BatchNorms, -> torch ``state_dict``.  ``backbone``: the
    port's backbone module, for the names of a CNN backbone."""
    table = _backbone_table(backbone)
    to_torch = {v: k for k, v in table.items()} if table else {}

    def module_key(mod):
        if tuple(mod) in to_torch:
            return to_torch[tuple(mod)]
        return ".".join(_flax_module_to_torch(list(mod)))

    sd = {}
    for path, v in flatten_tree(params).items():
        *mod, leaf = path
        key = module_key(mod)
        v = np.array(v, np.float32)
        if leaf == "kernel":
            v = v.transpose(4, 3, 0, 1, 2) if v.ndim == 5 else v.T
            name = "weight"
        elif leaf == "scale" and v.ndim == 0:  # an FCOS level's Scale
            v, name = v.reshape(1), "scale"
        elif leaf == "scale":
            name = "weight"
        else:
            name = leaf
        sd[f"{key}.{name}"] = torch.from_numpy(np.ascontiguousarray(v))
    for path, v in flatten_tree(batch_stats or {}).items():
        *mod, leaf = path
        key = module_key(mod)
        sd[f"{key}.running_{leaf}"] = torch.from_numpy(np.array(v, np.float32))
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)
    return sd


def to_jax_variables(state_dict: dict[str, torch.Tensor], backbone=None) -> dict:
    """Inverse of :func:`from_jax_params`: ``{"params": ..., "batch_stats":
    ...}`` (numpy leaves; ``batch_stats`` empty without BatchNorms)."""
    table = _backbone_table(backbone) or {}
    params, stats = {}, {}
    for key, t in state_dict.items():
        *mod, leaf = key.split(".")
        fmod = table.get(".".join(mod)) or tuple(_torch_module_to_flax(mod))
        if leaf == "num_batches_tracked":
            continue
        v = t.detach().cpu().float().numpy()
        if leaf in ("running_mean", "running_var"):
            stats[(*fmod, leaf[len("running_"):])] = np.ascontiguousarray(v)
            continue
        if leaf == "scale":  # an FCOS level's Scale, a scalar in flax
            v = v.reshape(())
        elif leaf == "weight":
            if v.ndim == 1:
                leaf = "scale"
            else:
                v = v.transpose(2, 3, 4, 1, 0) if v.ndim == 5 else v.T
                leaf = "kernel"
        # (ascontiguousarray makes a 0-d leaf 1-d)
        params[(*fmod, leaf)] = np.ascontiguousarray(v).reshape(v.shape)
    return {"params": unflatten_tree(params), "batch_stats": unflatten_tree(stats)}


def rcnn_from_jax_params(params: dict, batch_stats: dict | None = None,
                         backbone=None) -> dict[str, torch.Tensor]:
    """The RCNN stage's flax trees -> an ``RCNNDetector`` ``state_dict``:
    ``{"backbone": ..., "head": ...}`` and the backbone's own
    ``batch_stats`` (a CNN backbone) for ``--fine_tune``, the bare head tree
    for the features mode."""
    tree = params if "head" in params else {"head": params}
    return from_jax_params(tree, {"backbone": batch_stats} if batch_stats else None, backbone)


def rcnn_to_jax_variables(state_dict: dict[str, torch.Tensor], backbone=None) -> dict:
    """Inverse of :func:`rcnn_from_jax_params`: ``{"params": ...,
    "batch_stats": ...}`` in the JAX RCNN state's layout (the bare head
    tree without a backbone)."""
    v = to_jax_variables(state_dict, backbone)
    has_backbone = any(k.startswith("backbone.") for k in state_dict)
    return {"params": v["params"] if has_backbone else v["params"]["head"],
            "batch_stats": v["batch_stats"].get("backbone", {})}


def to_jax_params(state_dict: dict[str, torch.Tensor], backbone=None) -> dict:
    """The params tree of :func:`to_jax_variables`."""
    return to_jax_variables(state_dict, backbone)["params"]


def save_npz(path: str, params: dict, batch_stats: dict | None = None) -> None:
    """Save a flax params tree flattened to ``a/b/c`` keys; with
    ``batch_stats``, the tree ``{"params": ..., "batch_stats": ...}``."""
    tree = params if batch_stats is None else {"params": params, "batch_stats": batch_stats}
    np.savez(path, **{"/".join(k): v for k, v in flatten_tree(tree).items()})


def load_npz(path: str) -> dict:
    with np.load(path) as z:
        return unflatten_tree({tuple(k.split("/")): z[k] for k in z.files})


def load_variables(path: str) -> tuple[dict, dict]:
    """(params, batch_stats) of a ``save_npz`` file; a params-only file
    (a model without BatchNorms) gives empty ``batch_stats``."""
    tree = load_npz(path)
    if "params" in tree:
        return tree["params"], tree.get("batch_stats", {})
    return tree, {}


def load_weights_npz(model: torch.nn.Module, path: str) -> None:
    """Load a ``save_npz`` file into ``model`` (strict: a model with
    BatchNorms needs the file's ``batch_stats``)."""
    params, stats = load_variables(path)
    model.load_state_dict(from_jax_params(params, stats, model.backbone), strict=True)
