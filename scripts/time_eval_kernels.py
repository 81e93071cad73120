"""Time kernels K5 and K6 of one tree's torch port at the Swin-S eval stages.

Run on a GPU from the repository root::

    python scripts/time_eval_kernels.py [--tree DIR] [--label NAME]

It imports ``nerf_rpn_tpu_torch`` from DIR (default: this repository),
builds its kernels, and times K5 (``ln_partition_qkv``: LayerNorm + pad +
shift + partition + qkv) and K6 (``fused_mlp_block``) at the four stages of
the Swin-S eval bench shape (208x208x144: token grids 52x52x36, 26x26x18,
13x13x9, 7x7x5; K5 pads them to the window and shifts by 2, as a shifted
block does), in bf16 and f32.  K5's qkv weight and K6's two weights are
passed as the model passes them, ``Linear.weight.t()`` in the compute dtype
(a tree whose wrapper copies them pays for the copy, as on the model's path).  Each row is the device ms
per call of ``chip_smoke.time_one`` (back-to-back calls queued behind a
sleep kernel) for the kernel and for the tree's plain twin, the bound of
``chip_smoke.bound``, whether the output holds ``chip_smoke.close_enough``
against the twin, and, where the tree has a K5 or K6 planner, the plan (K5:
R tokens, BN columns, weight k-chunk BK and G tiles a block; K6: R tokens,
S hidden slices, BN and BK) and its blocks.  The last line sums the
bf16 and f32 rows into ms per eval scene at Swin-S's 2, 2, 18 and 2
launches per stage.

Inputs come from a fixed seed per row, so two trees get the same inputs:
to compare a parent commit, unpack it with ``git archive`` into a directory
that ``.gitignore`` lists and run both in turns (parent, this, this,
parent) in one chip call.  ``--dump DIR`` writes each row's kernel output
to DIR; ``--against DIR`` reads another tree's dump and adds to each row
whether the output equals it bit for bit (``bit_equal``; the summary's
``all_bit_equal``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEPTHS = (2, 2, 18, 2)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=str(ROOT))
    p.add_argument("--label", default="")
    p.add_argument("--dump", default="", help="write each row's output to this directory")
    p.add_argument("--against", default="",
                   help="a --dump directory of another tree to compare with bit for bit")
    args = p.parse_args(argv)
    if args.dump:
        Path(args.dump).mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.ops import fused_ln_qkv as k5
    from nerf_rpn_tpu_torch.ops import fused_mlp as k6

    # this repository's timing and tolerance, whichever tree is timed
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        raise RuntimeError("this script times the GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.build_all()

    rows = []
    for stage, (name, size, _, c, _) in enumerate(cs.EVAL_STAGES):
        pad = tuple(-(-s // 4) * 4 for s in size)
        tokens, hd = math.prod(size), 4 * c
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(100 + stage)
            x = torch.randn((1, *size, c), generator=gen, device=dev).to(dtype)
            s = 1 + 0.2 * torch.randn(c, generator=gen, device=dev)
            t = 0.2 * torch.randn(c, generator=gen, device=dev)
            wq = (torch.randn((3 * c, c), generator=gen, device=dev) * c ** -0.5).to(dtype).t()
            b = 0.5 * torch.randn(3 * c, generator=gen, device=dev)
            k5_args = (x, s, t, wq, b, (4, 4, 4), pad, (2, 2, 2))
            xm = x.reshape(tokens, c)
            k6_args = (xm, s, t,
                       (torch.randn((hd, c), generator=gen, device=dev) * c ** -0.5)
                       .to(dtype).t(),
                       (0.3 * torch.randn(hd, generator=gen, device=dev)).to(dtype),
                       (torch.randn((c, hd), generator=gen, device=dev) * hd ** -0.5)
                       .to(dtype).t(),
                       (0.3 * torch.randn(c, generator=gen, device=dev)).to(dtype))
            for kern, fn, twin, a in (
                    ("K5", k5.ln_partition_qkv, k5.ln_partition_qkv_reference, k5_args),
                    ("K6", k6.fused_mlp_block, k6.fused_mlp_block_reference, k6_args)):
                out = fn(*a)
                err, ok = cs.close_enough(torch, out, twin(*a), dtype)
                if kern == "K5":
                    moved = cs.nbytes(x, s, t, wq, b, out)
                    ops = 2 * tokens * c * 3 * c
                else:
                    moved = cs.nbytes(*a, out)
                    ops = 4 * tokens * c * hd
                row = dict(label=args.label, kernel=kern, stage=stage, C=c,
                           dtype=cs.dtype_name(dtype),
                           ms=cs.time_one(torch, lambda: fn(*a)),
                           plain_ms=cs.time_one(torch, lambda: twin(*a)),
                           **cs.bound(moved, ops, cs.dtype_name(dtype)),
                           max_abs_err=err, ok=ok)
                tag = f"{kern}_{stage}_{cs.dtype_name(dtype)}.pt"
                if args.dump:
                    torch.save(out.cpu(), Path(args.dump, tag))
                if args.against:
                    row["bit_equal"] = torch.equal(out.cpu(), torch.load(Path(args.against, tag)))
                if kern == "K5" and hasattr(k5, "ln_qkv_plan"):
                    n_win = out.shape[0]
                    plan = k5.ln_qkv_plan(n_win, c, dtype)
                    row.update(plan=list(plan), blocks=k5.plan_blocks(n_win, 64, c, plan))
                if kern == "K6" and hasattr(k6, "mlp_plan"):
                    plan = k6.mlp_plan(tokens, c, hd, dtype)
                    row.update(plan=list(plan), blocks=k6.plan_blocks(tokens, plan))
                rows.append(row)
                print("[time]", json.dumps(row), flush=True)

    def scene(kern, dtype):
        return sum(d * next(r["ms"] for r in rows if r["kernel"] == kern and r["stage"] == i
                            and r["dtype"] == dtype)
                   for i, d in enumerate(DEPTHS))

    summary = dict(label=args.label, device=torch.cuda.get_device_name(0),
                   k5_scene_bf16_ms=scene("K5", "bfloat16"),
                   k6_scene_bf16_ms=scene("K6", "bfloat16"),
                   k5_scene_f32_ms=scene("K5", "float32"),
                   k6_scene_f32_ms=scene("K6", "float32"),
                   all_ok=all(r["ok"] for r in rows))
    if args.against:
        summary["all_bit_equal"] = all(r["bit_equal"] for r in rows)
    print("[summary]", json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
