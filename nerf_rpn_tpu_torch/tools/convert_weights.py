"""Reference (torch) checkpoint -> flax-layout ``.msgpack`` (port of
``nerf_rpn_tpu/tools/convert_weights.py``).

The released NeRF-RPN weights are torch files ``{epoch,
backbone_state_dict, rpn_head_state_dict | fcos_state_dict, train_args}``.
This tool writes the flax variables ``{"params": {"backbone": ...,
"rpn_head" | "fcos_head": ...}, "batch_stats": {"backbone": ...} | {}}``
that the JAX package's tool writes for the same file -- the file the JAX
drivers' ``--checkpoint`` reads, and this package's too -- without jax or
flax: the state dict goes through ``weights.to_jax_variables`` (the
reference keys are this package's parameter names) and
``train/flax_msgpack.packb``.  The RPN head's output channels go from the
reference's anchor order to the JAX package's
(``models/anchors.anchor_permutation``), unless the file is one of this
package's, which says ``anchor_order: "port"``.

Usage: ``python -m nerf_rpn_tpu_torch.tools.convert_weights --checkpoint
x.pt --backbone_type swin_s --out params.msgpack [--fcos] [--rotated]``.
"""

from __future__ import annotations

import argparse

import torch

from nerf_rpn_tpu_torch import weights as weights_lib
from nerf_rpn_tpu_torch.models.nerf_rpn import build_backbone
from nerf_rpn_tpu_torch.train.checkpoint import ANCHOR_ORDER, reference_to_port_anchors
from nerf_rpn_tpu_torch.train.flax_msgpack import write_msgpack

# the JAX tool's backbones (``convert_backbone``); VGG at its default
# input_size of 160
BACKBONES = ("resnet", "vgg_AF", "vgg_EF", "swin_t", "swin_s", "swin_b", "swin_l")


def convert_checkpoint(ckpt: dict, backbone_type: str, fcos: bool = False,
                       rotated: bool | None = None) -> dict:
    """A reference checkpoint dict -> ``{"params", "batch_stats"}`` (numpy
    leaves).  ``rotated``: where given, the RPN head must have 8 (True) or
    6 (False) deltas an anchor."""
    sd = {f"backbone.{k}": v for k, v in ckpt["backbone_state_dict"].items()}
    if fcos:
        sd.update({f"fcos_head.{k[len('head.'):]}": v
                   for k, v in ckpt["fcos_state_dict"].items() if k.startswith("head.")})
    else:
        head = ckpt["rpn_head_state_dict"]
        a = head["cls_logits.weight"].shape[0]
        reg = head["bbox_pred.weight"].shape[0] // a
        if rotated is not None and reg != (8 if rotated else 6):
            raise ValueError(f"the head predicts {reg} deltas an anchor; --rotated is {rotated}")
        if ckpt.get("anchor_order") != ANCHOR_ORDER:
            head = reference_to_port_anchors(head)
        sd.update({f"rpn_head.{k}": v for k, v in head.items()})
    with torch.device("meta"):
        backbone = build_backbone(backbone_type, 160)
    return weights_lib.to_jax_variables(sd, backbone)


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert torch NeRF-RPN weights to flax.")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--backbone_type", required=True, choices=BACKBONES)
    p.add_argument("--out", required=True)
    p.add_argument("--fcos", action="store_true")
    p.add_argument("--rotated", action="store_true")
    p.add_argument("--conv_depth", type=int, default=4,
                   help="Accepted as in the JAX tool; the head's depth is read from the file.")
    args = p.parse_args(argv)
    ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    variables = convert_checkpoint(ckpt, args.backbone_type, args.fcos,
                                   None if args.fcos else args.rotated)
    write_msgpack(args.out, variables)
    print(f"wrote {args.out}")
    return variables


if __name__ == "__main__":
    main()
