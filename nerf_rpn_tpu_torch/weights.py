"""Flax parameter tree <-> torch ``state_dict`` for the anchor RPN and FCOS.

The JAX package's params ``{"backbone": ..., "rpn_head": ...}`` map onto
this package's ``NeRFRPN`` (Swin backbone), and ``{"backbone": ...,
"fcos_head": ...}`` onto its ``FCOSOverNeRF``, one leaf at a time:

- conv kernels (kx, ky, kz, in, out) -> weight (out, in, kx, ky, kz);
- dense kernels (in, out) -> weight (out, in);
- LayerNorm and GroupNorm ``scale`` -> ``weight``; biases and the
  relative-position tables unchanged;
- the FCOS head's ``{cls,bbox}_tower_{d}_conv`` / ``_gn`` ->
  ``{cls,bbox}_tower.{3d}`` / ``.{3d+1}`` and its per-level ``scale_{l}``
  (a scalar) -> ``scales.{l}.scale`` (shape (1,)), the reference keys.

Module names follow the reference torch keys (see ``models/swin.py``), so
``nerf_rpn_tpu.tools.convert_weights.convert_swin_fpn`` applied to the
backbone part of a port ``state_dict`` gives the flax tree back.  RPN-head
channels stay in the JAX package's anchor order.

``save_npz`` / ``load_npz`` store a flax tree flattened to ``a/b/c`` keys
(the format of ``run_rpn --weights``).
"""

from __future__ import annotations

import re

import numpy as np
import torch


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


def from_jax_params(params: dict) -> dict[str, torch.Tensor]:
    """Flax params tree (numpy leaves) -> torch ``state_dict``."""
    sd = {}
    for path, v in flatten_tree(params).items():
        *mod, leaf = path
        key = ".".join(_flax_module_to_torch(list(mod)))
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
    return sd


def to_jax_params(state_dict: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`from_jax_params` (numpy leaves)."""
    flat = {}
    for key, t in state_dict.items():
        *mod, leaf = key.split(".")
        v = t.detach().cpu().float().numpy()
        if leaf == "scale":  # an FCOS level's Scale, a scalar in flax
            v = v.reshape(())
        elif leaf == "weight":
            if v.ndim == 1:
                leaf = "scale"
            else:
                v = v.transpose(2, 3, 4, 1, 0) if v.ndim == 5 else v.T
                leaf = "kernel"
        flat[(*_torch_module_to_flax(mod), leaf)] = np.ascontiguousarray(v)
    return unflatten_tree(flat)


def save_npz(path: str, params: dict) -> None:
    """Save a flax params tree flattened to ``a/b/c`` keys."""
    np.savez(path, **{"/".join(k): v for k, v in flatten_tree(params).items()})


def load_npz(path: str) -> dict:
    with np.load(path) as z:
        return unflatten_tree({tuple(k.split("/")): z[k] for k in z.files})
