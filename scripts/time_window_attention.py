"""Time kernels K1, K2 and K4 of one tree's torch port at the main path's shapes.

Run on a GPU from the repository root::

    python scripts/time_window_attention.py [--tree DIR] [--label NAME]

It imports ``nerf_rpn_tpu_torch`` from DIR (default: this repository),
builds its kernels, and times K4 (``fused_window_attention``) at the four
Swin-S eval stages, K1 (``window_attention``) at the four eval stages
without a mask and at the four train stages (160^3, batch 2) with and
without the real shift mask, and K2 (``window_attention_backward``) at the
four train stages with and without the mask, in f32 and bf16.  Each row is
the device ms per call of ``chip_smoke.time_one`` (back-to-back calls
queued behind a sleep kernel) and whether the output holds
``chip_smoke.close_enough`` (K2: ``chip_smoke.k2_close_enough``) against
the tree's plain twin.  The last line sums the bf16 rows into K1 + K4
device ms per eval scene, and K1 and K2 ms per train step (Swin-S depths
2, 2, 18, 2: half the blocks of a stage shifted).

Inputs come from a fixed seed per row, so two trees get the same inputs:
to compare a parent commit, unpack it with ``git archive`` into a directory
that ``.gitignore`` lists and run both in turns (parent, this, this,
parent) in one chip call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEPTHS = (2, 2, 18, 2)
# Swin-S train shape 160^3, batch 2: (windows, heads, C, padded token grid)
TRAIN_STAGES = [(2000, 3, 96, (40, 40, 40)), (250, 6, 192, (20, 20, 20)),
                (54, 12, 384, (12, 12, 12)), (16, 24, 768, (8, 8, 8))]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=str(ROOT))
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.models.swin import shift_attn_mask, shift_mask_patterns
    from nerf_rpn_tpu_torch.ops import window_attention as wa

    # this repository's timing and tolerance, whichever tree is timed
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        raise RuntimeError("this script times the GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.build_all()

    cases = []  # (kernel, stage, W, H, C, mask or (table, ids))
    for i, (name, size, heads, c) in enumerate(cs.EVAL_STAGES):
        pad = tuple(-(-s // 4) * 4 for s in size)
        table, ids = shift_mask_patterns(pad, (4, 4, 4), (2, 2, 2))
        extra = (torch.from_numpy(table).to(dev), torch.from_numpy(ids).to(dev))
        cases.append(("K4", i, "eval", len(ids), heads, c, extra))
        cases.append(("K1", i, "eval", len(ids), heads, c, None))
    for i, (w, heads, c, pad) in enumerate(TRAIN_STAGES):
        mask = torch.from_numpy(shift_attn_mask(pad, (4, 4, 4), (2, 2, 2))).to(dev)
        cases.append(("K1", i, "train", w, heads, c, None))
        cases.append(("K1", i, "train", w, heads, c, mask))
    for i, (w, heads, c, pad) in enumerate(TRAIN_STAGES):
        mask = torch.from_numpy(shift_attn_mask(pad, (4, 4, 4), (2, 2, 2))).to(dev)
        cases.append(("K2", i, "train", w, heads, c, None))
        cases.append(("K2", i, "train", w, heads, c, mask))

    rows = []
    for seed, (kern, stage, route, w, heads, c, extra) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(seed)
            qkv = torch.randn((w, 64, 3 * c), generator=gen, device=dev).to(dtype)
            bias = 0.5 * torch.randn((heads, 64, 64), generator=gen, device=dev)
            if kern == "K4":
                q, k, v = cs.sdpa_views(qkv, heads)
                fn = lambda: wa.fused_window_attention(q, k, v, bias, *extra)  # noqa: E731
                ref = wa.fused_window_attention_reference(q, k, v, bias, *extra)
                err, ok = cs.close_enough(torch, fn(), ref, dtype)
            elif kern == "K2":
                dout = torch.randn((w, 64, c), generator=gen, device=dev).to(dtype)
                fn = lambda: wa.window_attention_backward(qkv, dout, bias, extra, heads)  # noqa: E731
                ref = wa.window_attention_backward_reference(qkv, dout, bias, extra, heads)
                err, _, ok = cs.k2_close_enough(torch, *fn(), *ref, dtype)
            else:
                fn = lambda: wa.window_attention(qkv, bias, extra, heads)  # noqa: E731
                ref = wa.window_attention_reference(qkv, bias, extra, heads)
                err, ok = cs.close_enough(torch, fn(), ref, dtype)
            row = dict(label=args.label, kernel=kern, route=route, stage=stage, W=w, H=heads,
                       C=c, mask=kern == "K4" or extra is not None, dtype=cs.dtype_name(dtype),
                       ms=cs.time_one(torch, fn), max_abs_err=err, ok=ok)
            rows.append(row)
            print("[time]", json.dumps(row), flush=True)

    def ms(kern, route, stage, masked):
        return next(r["ms"] for r in rows if r["kernel"] == kern and r["route"] == route
                    and r["stage"] == stage and r["mask"] == masked and r["dtype"] == "bfloat16")

    # per stage, half the blocks are shifted: K4 (eval) or K1 masked (train)
    summary = dict(
        label=args.label, device=torch.cuda.get_device_name(0),
        k1_k4_eval_scene_bf16_ms=sum(d / 2 * (ms("K1", "eval", s, False) + ms("K4", "eval", s, True))
                                     for s, d in enumerate(DEPTHS)),
        k1_train_step_bf16_ms=sum(d / 2 * (ms("K1", "train", s, False) + ms("K1", "train", s, True))
                                  for s, d in enumerate(DEPTHS)),
        k2_train_step_bf16_ms=sum(d / 2 * (ms("K2", "train", s, False) + ms("K2", "train", s, True))
                                  for s, d in enumerate(DEPTHS)),
        all_ok=all(r["ok"] for r in rows))
    print("[summary]", json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
