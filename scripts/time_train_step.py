"""Time the train step of one tree's torch port at the train path's shape.

Run on a GPU from the repository root::

    python scripts/time_train_step.py [--tree DIR] [--label NAME] [--rotated_bbox] [--fcos]

It imports ``nerf_rpn_tpu_torch`` from DIR (default: this repository),
writes the synthetic 160^3 scenes of ``chip_smoke.py``'s train path
(Swin-S, bf16, batch 2; OBBs and ``--rotated_bbox``, the
``scripts/train.sh`` configuration, with ``--rotated_bbox``) into a
temporary directory, and runs
``chip_smoke.time_train_steps``: 20 timed steps after 3 warm-up steps on
the first batch, CUDA events around each step, the peak device memory
and one profiled step's device-busy ms.  With ``--fcos`` the step is the
FCOS step of ``scripts/train_fcos.sh``'s flags.  It prints one ``[train
steps]`` line with the label and the card.

To compare a parent commit, unpack it with ``git archive`` into a
directory that ``.gitignore`` lists and run both in turns (parent, this,
this, parent) in one chip call: the step is host-bound, and one process
reads tens of percent apart from the next.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=str(ROOT))
    p.add_argument("--label", default="")
    p.add_argument("--rotated_bbox", action="store_true")
    p.add_argument("--fcos", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    from nerf_rpn_tpu_torch import kernels

    # this repository's data and timing helpers, whichever tree is timed
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        raise RuntimeError("this script times the GPU: torch.cuda.is_available() is False")
    kernels.build_all()
    with tempfile.TemporaryDirectory() as work:
        data, common = cs.write_train_data(work, rotated=args.rotated_bbox)
        print(f"[label] {args.label} ({torch.cuda.get_device_name(0)})", flush=True)
        if args.fcos:
            common = [*common, *cs.FCOS_TRAIN_FLAGS]
        row = cs.time_train_steps(torch, data, common, fcos=args.fcos)
    return dict(label=args.label, **row)


if __name__ == "__main__":
    main()
