"""Time kernel K5 under many plans at the Swin-S eval stages and fit the
planner's cost model to the times.

Run on a GPU from the repository root::

    python scripts/time_ln_qkv_plans.py [--per-case 24]

For each of the four eval stages of the bench shape (as
``scripts/time_eval_kernels.py`` sets them up) in bf16 and f32, it times
``--per-case`` plans (R tokens, BN columns, BK k-chunk, G tiles a block):
the planner's pick, the cost model's cheapest others and an even sample of
the rest, each through the C entry point with ``chip_smoke.time_one`` and
each checked with ``chip_smoke.close_enough`` against the plain twin.  Then
it fits the weights of ``ops.fused_ln_qkv.plan_cost`` (the terms of
``plan_terms``) by non-negative least squares on the relative error
and prints them, with each case's pick under the fitted weights beside the
fastest plan measured.  One JSON line per timed plan, then a ``[fit]`` line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--per-case", type=int, default=24)
    args = p.parse_args(argv)
    import numpy as np
    import torch
    from scipy.optimize import nnls

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.ops import fused_ln_qkv as k5

    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        raise RuntimeError("this script times the GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.build_all()

    rows = []
    for stage, (name, size, _, c) in enumerate(cs.EVAL_STAGES):
        pad = tuple(-(-s // 4) * 4 for s in size)
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(100 + stage)
            x = torch.randn((1, *size, c), generator=gen, device=dev).to(dtype)
            s = 1 + 0.2 * torch.randn(c, generator=gen, device=dev)
            t = 0.2 * torch.randn(c, generator=gen, device=dev)
            wn = (torch.randn((3 * c, c), generator=gen, device=dev) * c ** -0.5).to(dtype)
            b = 0.5 * torch.randn(3 * c, generator=gen, device=dev)
            ref = k5.ln_partition_qkv_reference(x, s, t, wn.t(), b, (4, 4, 4), pad, (2, 2, 2))
            out = torch.empty_like(ref)
            n_win = ref.shape[0]
            pick = k5.ln_qkv_plan(n_win, c, dtype)
            plans = sorted((k5.Plan(r, bn, bk, g) for r in k5.ROWS for bk in k5.K_CHUNKS
                            for bn in range(16, 3 * c + 1, 16) for g in range(1, 3 * c // bn + 1)
                            if c % bk == 0 and 3 * c % bn == 0 and r * bn % 512 == 0
                            and r * bn // 512 in k5.WARP_TILES and 3 * c // bn % g == 0
                            and k5.plan_smem_bytes(c, k5.Plan(r, bn, bk, g), dtype)
                            <= k5.MAX_BLOCK_SMEM),
                           key=lambda q: k5.plan_cost(n_win, c, dtype, q))
            head = args.per_case * 2 // 3
            rest = plans[head:]
            step = max(1, len(rest) // max(1, args.per_case - head))
            chosen = list(dict.fromkeys([pick, *plans[:head], *rest[::step]]))[:args.per_case]
            for plan in chosen:
                def run(plan=plan):
                    kernels.launch("ln_partition_qkv", x.data_ptr(), s.data_ptr(), t.data_ptr(),
                                   wn.data_ptr(), b.data_ptr(), out.data_ptr(), 1, *size, c, *pad,
                                   2, 2, 2, 4, 4, 4, *plan, kernels.DTYPE_CODES[dtype],
                                   torch.cuda.current_stream(dev).cuda_stream)
                run()
                err, ok = cs.close_enough(torch, out, ref, dtype)
                row = dict(stage=stage, C=c, dtype=cs.dtype_name(dtype), plan=list(plan),
                           picked=plan == pick, ms=cs.time_one(torch, run), ok=ok,
                           model_us=k5.plan_cost(n_win, c, dtype, plan),
                           blocks=k5.plan_blocks(n_win, 64, c, plan),
                           resident=k5.plan_resident(c, plan, dtype),
                           features=k5.plan_terms(n_win, c, dtype, plan))
                rows.append(row)
                print(json.dumps(row), flush=True)

    x = np.array([r["features"] for r in rows])
    y = np.array([r["ms"] * 1e3 for r in rows])
    weights, _ = nnls(x / y[:, None], np.ones(len(y)))
    fitted = x @ weights
    cases = []
    for stage in range(len(cs.EVAL_STAGES)):
        for dtype in ("bfloat16", "float32"):
            case = [i for i, r in enumerate(rows) if r["stage"] == stage and r["dtype"] == dtype]
            best = min(case, key=lambda i: y[i])
            pick = min(case, key=lambda i: fitted[i])
            picked = next(i for i in case if rows[i]["picked"])
            cases.append(dict(stage=stage, dtype=dtype, fastest=rows[best]["plan"],
                              fastest_ms=rows[best]["ms"], planner=rows[picked]["plan"],
                              planner_ms=rows[picked]["ms"], refit_pick=rows[pick]["plan"]))
    fit = dict(device=torch.cuda.get_device_name(0),
               weights=dict(zip(("W_PASS", "W_CHUNK", "W_MMA", "W_KB", "W_SM_MMA", "W_SM_LN",
                                 "W_SM_OUT"), [round(float(w), 5) for w in weights])),
               median_rel_err=float(np.median(np.abs(fitted - y) / y)), cases=cases,
               all_ok=all(r["ok"] for r in rows))
    print("[fit]", json.dumps(fit), flush=True)
    return fit


if __name__ == "__main__":
    main()
