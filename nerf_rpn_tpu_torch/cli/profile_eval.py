"""Where the eval step's time goes on the GPU: Swin-S at the bench shape.

Builds the anchor RPN (random weights from ``--seed``; OBBs with
``--rotated_bbox``) and the eval step of ``run_rpn`` at 200x200x130 padded
to ``--pad_multiple`` or, with ``--fcos``, the FCOS detector and the eval
step of ``run_fcos`` at 160^3 (``test_fcos.sh``'s head flags), then:

1. times ``--scenes`` scenes after 10 warm-up scenes with CUDA events,
   split into forward and propose (ms per scene, mean and median);
2. times 10 more forwards by layer -- each stage's Swin blocks and patch
   merge, the FPN neck, the detection head -- with CUDA events from forward
   hooks (ms per scene);
3. runs ``--profiled`` more scenes under ``torch.profiler`` and prints, per
   scene: the device time of every kernel name (top ``--top``), the
   launches, the device-busy time (the union of kernel intervals) and its
   share of the profiled window, and the launch counts of the port's own
   kernels.

Run on a GPU from the repository root::

    python -m nerf_rpn_tpu_torch.cli.profile_eval [--bf16] [--rotated_bbox] \\
        [--fcos] [--scenes 50] [--trace out.json]

It prints one JSON line per section; ``--trace`` writes the chrome trace.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch

from nerf_rpn_tpu_torch import kernels
from nerf_rpn_tpu_torch.cli import run_fcos, run_rpn


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backbone_type", default="swin_s")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--rotated_bbox", action="store_true")
    p.add_argument("--fcos", action="store_true")
    p.add_argument("--pad_multiple", type=int, default=16)
    p.add_argument("--scenes", type=int, default=50)
    p.add_argument("--profiled", type=int, default=5)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", default="")
    return p.parse_args(argv)


def _union_us(intervals) -> float:
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def layer_times(model, forward, scenes: int = 10) -> dict[str, float]:
    """Device ms per scene of each layer group, from CUDA events that
    forward hooks record around every module of the group."""
    from nerf_rpn_tpu_torch.models.swin import PatchMerging3D

    head = model.fcos_head if hasattr(model, "fcos_head") else model.rpn_head
    groups = {model.backbone.fpn_neck: "fpn neck", head: "head"}
    for i, stage in enumerate(model.backbone.stages):
        for layer in stage:
            groups[layer] = f"stage{i} " + ("merge" if isinstance(layer, PatchMerging3D)
                                            else "blocks")
    spans, handles = [], []
    for module, name in groups.items():
        def pre(m, inp, name=name):
            spans.append([name, torch.cuda.Event(enable_timing=True), None])
            spans[-1][1].record()

        def post(m, inp, out):
            spans[-1][2] = torch.cuda.Event(enable_timing=True)
            spans[-1][2].record()
        handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
    for _ in range(scenes):
        forward()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    out = defaultdict(float)
    for name, a, b in spans:
        out[name] += a.elapsed_time(b) / scenes
    return dict(out)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_eval times the GPU: torch.cuda.is_available() is False")
    cli = run_fcos if args.fcos else run_rpn
    cargs = cli.parse_args(["--mode", "benchmark", "--backbone_type", args.backbone_type,
                            "--pad_multiple", str(args.pad_multiple), "--seed",
                            str(args.seed), *(["--bf16"] if args.bf16 else []),
                            *(["--rotated_bbox"] if args.rotated_bbox else []),
                            *(["--norm_reg_targets", "--centerness_on_reg"]
                              if args.fcos else [])])
    trainer = cli.Trainer(cargs)
    shape = tuple(cli.round_up(s, args.pad_multiple) for s in cli.BENCH_SHAPE)
    step = trainer.eval_step(shape)
    rng = np.random.default_rng(args.seed)
    grids = torch.from_numpy(rng.standard_normal((1, *shape, 4), np.float32)).to(
        trainer.device, trainer.dtype)
    ori = torch.tensor([cli.BENCH_SHAPE], dtype=torch.int32, device=trainer.device)

    def scene():
        """The forward's outputs that propose reads: all but the voxel scores."""
        return step.forward(grids)[:3] if args.fcos else step.forward(grids)[1:3]

    for _ in range(10):
        step.propose(*scene(), ori)
    torch.cuda.synchronize()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(args.scenes)]
    for a, b, c in ev:
        a.record()
        heads = scene()
        b.record()
        step.propose(*heads, ori)
        c.record()
    torch.cuda.synchronize()
    fwd = np.array([a.elapsed_time(b) for a, b, _ in ev])
    prop = np.array([b.elapsed_time(c) for _, b, c in ev])
    timing = {"device": torch.cuda.get_device_name(0), "shape": list(shape),
              "dtype": str(trainer.dtype), "rotated": args.rotated_bbox, "fcos": args.fcos,
              "scenes": args.scenes,
              "forward_ms": float(fwd.mean()), "forward_median_ms": float(np.median(fwd)),
              "propose_ms": float(prop.mean()), "total_ms": float((fwd + prop).mean())}
    print("[timing]", json.dumps(timing), flush=True)
    layers = layer_times(trainer.model, scene)
    print("[layers]", json.dumps(dict(layers, sum_ms=sum(layers.values()))), flush=True)

    kernels.reset_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.profiled):
            step.propose(*scene(), ori)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launches = {k: v / args.profiled for k, v in kernels.counts().items() if v}
    by_name, spans = defaultdict(lambda: [0.0, 0]), []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us()
            by_name[e.name][1] += 1
            spans.append((e.time_range.start, e.time_range.end))
    n = args.profiled
    busy_us = _union_us(spans)
    summary = {"profiled_scenes": n, "device_kernels_per_scene": len(spans) / n,
               "device_busy_ms_per_scene": busy_us / n / 1e3,
               "profiled_wall_ms_per_scene": wall_us / n / 1e3,
               "busy_share_of_profiled_window": busy_us / wall_us,
               "port_kernel_launches_per_scene": launches}
    print("[profile]", json.dumps(summary), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    for name, (us, count) in top:
        print("[kernel]", json.dumps({"name": name[:120], "ms_per_scene": us / n / 1e3,
                                      "launches_per_scene": count / n}), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return {"timing": timing, "profile": summary}


if __name__ == "__main__":
    main()
