"""Time the NMS path of one tree's torch port: K3, the resolve kernel,
``nms_mask`` and the eval step's propose, at the Swin-S bench scene.

Run on a GPU from the repository root::

    python scripts/time_nms.py [--tree DIR] [--label NAME] [--rotated_bbox]

It imports ``nerf_rpn_tpu_torch`` from DIR (default: this repository),
builds its kernels and prints one JSON line per measurement:

- ``K3``: the suppression graph on ``chip_smoke.k3_boxes`` (4 x 2560 boxes,
  IoU 0.3), device ms per call of ``chip_smoke.time_one`` (back-to-back
  calls queued behind a sleep kernel) and its bound;
- ``nms``: the bench scene's NMS problem (the Swin-S bf16 eval step of
  ``run_rpn --mode benchmark`` at 208x208x144, random weights from seed 0:
  one problem per FPN level), as ``propose`` hands it to ``nms_mask``:
  ``nms_mask`` ms per call (``time_one``; a tree whose ``nms_mask``
  synchronises pays its host round trips), K3 ms on the sorted problem
  and, where the tree has it, the resolve kernel's ms; the keep-set count;
- ``propose``: the eval step's propose at the bench scene, ``--reps``
  scenes after 5 warm-up scenes, timed as ``run_rpn --mode benchmark``
  times it (CUDA events around propose after each scene's forward), plus
  the host wall ms of propose alone followed by ``torch.cuda.synchronize``.

With ``--rotated_bbox`` (this tree's port only) the scene is the rotated
eval step's, its NMS problem OBBs, and ``nms`` splits the rotated graph
build (``ops/nms.obb_suppression_graph``): the gate (the IoU bound and
``nonzero``, chunk by chunk), the polygon clip of the gated pairs, the
whole graph and the resolve kernel, each in ms (``time_one``; the gate
synchronises once a chunk), with the gated pairs, and the device-busy ms
and kernel count of one ``nms_mask`` call under ``torch.profiler``.

Inputs come from fixed seeds, so two trees get the same inputs: to compare
a parent commit, unpack it with ``git archive`` into a directory that
``.gitignore`` lists and run both in turns (parent, this, this, parent) in
one chip call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=str(ROOT))
    p.add_argument("--label", default="")
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--rotated_bbox", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.ops import nms_graph
    from nerf_rpn_tpu_torch.ops.nms import nms_mask

    # this repository's timing and bench inputs, whichever tree is timed
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        raise RuntimeError("this script times the GPU: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    kernels.build_all()
    label = dict(label=args.label, device=torch.cuda.get_device_name(0))

    boxes = cs.k3_boxes(torch, dev)
    pk, nk = boxes.shape[:2]
    k3 = dict(label, P=pk, Np=nk,
              ms=cs.time_one(torch, lambda: nms_graph.aabb_suppression_graph(boxes, 0.3)),
              **cs.bound(cs.nbytes(boxes) + 4 * pk * nk * nk // 32, cs.graph_ops(pk, nk),
                         "float32"))
    print("[K3]", json.dumps(k3), flush=True)

    eval_step, grids, ori = cs.bench_eval_step(torch, rotated=args.rotated_bbox)
    _, obj, dl, _ = eval_step.forward(grids)
    nb, ns, nv, thresh = cs.capture_nms_problem(eval_step, obj, dl, ori)
    if args.rotated_bbox:
        nms = dict(label, **time_obb_nms(torch, cs, nb, ns, nv, thresh))
        print("[nms]", json.dumps(nms), flush=True)
        return dict(k3=k3, nms=nms, propose=time_propose(torch, args, label, eval_step,
                                                          grids, obj, dl, ori))
    pad = (-nb.shape[1]) % 256
    order = torch.sort(-torch.where(nv, ns, -1e10), dim=-1, stable=True).indices
    sboxes = torch.nn.functional.pad(
        torch.gather(nb, 1, order[..., None].expand(*order.shape, 6)).float(), (0, 0, 0, pad))
    keep = nms_mask(nb, ns, nv, thresh)
    nms = dict(label, P=nb.shape[0], N=nb.shape[1], valid=int(nv.sum()), kept=int(keep.sum()),
               nms_mask_ms=cs.time_one(torch, lambda: nms_mask(nb, ns, nv, thresh)),
               k3_ms=cs.time_one(torch, lambda: nms_graph.aabb_suppression_graph(sboxes, thresh)))
    if hasattr(nms_graph, "resolve_keep"):
        svalid = torch.nn.functional.pad(torch.gather(nv, 1, order), (0, pad))
        graph = nms_graph.aabb_suppression_graph(sboxes, thresh)
        nms["resolve_ms"] = cs.time_one(torch, lambda: nms_graph.resolve_keep(graph, svalid))
    print("[nms]", json.dumps(nms), flush=True)
    return dict(k3=k3, nms=nms, propose=time_propose(torch, args, label, eval_step, grids,
                                                      obj, dl, ori))


def time_obb_nms(torch, cs, boxes, scores, valid, thresh) -> dict:
    """The rotated graph build at the scene's problem, split into its gate
    and its clip, beside ``nms_mask`` and the resolve kernel."""
    from nerf_rpn_tpu_torch.ops import nms as nms_lib
    from nerf_rpn_tpu_torch.ops.nms_graph import resolve_keep
    from nerf_rpn_tpu_torch.ops.rotated_iou_pairwise import iou_rotated_3d_pairs_soa

    _, sboxes, svalid = nms_lib.sort_problems(boxes, scores, valid)
    np_ = sboxes.shape[1]
    chunks = [(r0, min(r0 + nms_lib.ROW_CHUNK, np_)) for r0 in range(0, np_, nms_lib.ROW_CHUNK)]

    def gate():
        return [nms_lib.gated_pairs(sboxes, r0, r1, thresh) for r0, r1 in chunks]

    gated = gate()

    def clip():
        for (r0, r1), idx in zip(chunks, gated):
            for s in range(0, idx.shape[0], nms_lib.PAIR_BATCH):
                pi, ri, ci = idx[s:s + nms_lib.PAIR_BATCH].unbind(1)
                iou_rotated_3d_pairs_soa(sboxes[pi, r0 + ri], sboxes[pi, ci])

    graph = nms_lib.obb_suppression_graph(sboxes, thresh)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        nms_lib.nms_mask(boxes, scores, valid, thresh)
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    n_gated = sum(int(i.shape[0]) for i in gated)
    return dict(P=boxes.shape[0], N=boxes.shape[1], Np=np_, valid=int(valid.sum()),
                pairs=boxes.shape[0] * np_ * (np_ - 1) // 2, gated=n_gated,
                kept=int(nms_lib.nms_mask(boxes, scores, valid, thresh).sum()),
                nms_mask_ms=cs.time_one(
                    torch, lambda: nms_lib.nms_mask(boxes, scores, valid, thresh)),
                graph_ms=cs.time_one(
                    torch, lambda: nms_lib.obb_suppression_graph(sboxes, thresh)),
                gate_ms=cs.time_one(torch, gate), clip_ms=cs.time_one(torch, clip),
                resolve_ms=cs.time_one(torch, lambda: resolve_keep(graph, svalid)),
                nms_mask_device_busy_ms=busy_us / 1e3, nms_mask_kernels=len(spans))


def time_propose(torch, args, label, eval_step, grids, obj, dl, ori) -> dict:
    """propose at the scene: the benchmark's protocol, then host wall ms."""
    import numpy as np

    # the benchmark's protocol: events around propose after each forward
    for _ in range(5):
        eval_step.propose(obj, dl, ori)
    torch.cuda.synchronize()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)] for _ in range(args.reps)]
    for a, b in events:
        _, o, d, _ = eval_step.forward(grids)
        a.record()
        eval_step.propose(o, d, ori)
        b.record()
    torch.cuda.synchronize()
    ev_ms = np.array([a.elapsed_time(b) for a, b in events])
    wall = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_step.propose(obj, dl, ori)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    prop = dict(label, reps=args.reps, propose_ms=float(ev_ms.mean()),
                propose_median_ms=float(np.median(ev_ms)),
                propose_wall_ms=float(np.mean(wall)),
                propose_wall_median_ms=float(np.median(wall)))
    print("[propose]", json.dumps(prop), flush=True)
    return prop


if __name__ == "__main__":
    main()
