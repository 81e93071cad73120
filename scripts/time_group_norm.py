"""Time the FCOS head's GroupNorm on the card: the port's form against
``torch.group_norm``.

Run on a GPU from the repository root::

    python scripts/time_group_norm.py

At each FCOS level of the bench's 160^3 scene (40^3, 20^3, 10^3, 5^3
voxels, 256 channels, 32 groups, batch 1), in bf16 and f32, it times
``models/layers.group_norm`` (the JAX head's ``GroupNormFast`` arithmetic:
one-pass f32 moments, the apply in the input's dtype) and the plain
``torch.group_norm`` on a channels-first view of an f32 copy with the
output rounded back (the form before the space axis' GroupNorm), each the
device ms per call of ``chip_smoke.time_one`` in turns (port, plain, plain,
port), and their largest difference over the plain form's largest
magnitude.  The last line sums the rows into ms per FCOS scene at the
head's 8 GroupNorms a level (4 tower convs, two towers).  It prints the
card's name and power limit first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch import nn  # noqa: E402

import chip_smoke  # noqa: E402
from nerf_rpn_tpu_torch.models.layers import group_norm  # noqa: E402

LEVELS = (40, 20, 10, 5)
CHANNELS, GROUPS = 256, 32
PER_LEVEL = 8


def plain_group_norm(x, gn, dtype):
    xf = x.permute(0, 4, 1, 2, 3).to(torch.promote_types(x.dtype, torch.float32))
    y = torch.group_norm(xf, gn.num_groups, gn.weight, gn.bias, gn.eps)
    return y.permute(0, 2, 3, 4, 1).to(dtype)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("time_group_norm.py needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    gn = nn.GroupNorm(GROUPS, CHANNELS).to(dev)
    with torch.no_grad():
        gn.weight.copy_(1 + 0.2 * torch.randn(CHANNELS, generator=gen, device=dev))
        gn.bias.copy_(0.2 * torch.randn(CHANNELS, generator=gen, device=dev))
    total = {}
    for dtype in (torch.bfloat16, torch.float32):
        for side in LEVELS:
            x = (0.5 + torch.randn((1, side, side, side, CHANNELS), generator=gen,
                                   device=dev)).to(dtype)
            with torch.no_grad():
                port = lambda: group_norm(x, gn, dtype)  # noqa: E731
                plain = lambda: plain_group_norm(x, gn, dtype)  # noqa: E731
                p1, q1, q2, p2 = (chip_smoke.time_one(torch, f)
                                  for f in (port, plain, plain, port))
                want = plain().float()
                err = ((port().float() - want).abs().max() / want.abs().max()).item()
            row = {"dtype": str(dtype).split(".")[-1], "voxels": f"{side}^3",
                   "port_ms": (p1 + p2) / 2, "plain_ms": (q1 + q2) / 2, "max_rel_diff": err}
            print(json.dumps(row), flush=True)
            for k in ("port_ms", "plain_ms"):
                total[row["dtype"], k] = total.get((row["dtype"], k), 0.0) + PER_LEVEL * row[k]
    print(json.dumps({"ms_per_fcos_scene": {f"{d} {k}": v for (d, k), v in total.items()}}))


if __name__ == "__main__":
    main()
