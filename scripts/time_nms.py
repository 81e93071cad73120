"""Time the NMS path of one tree's torch port: K3, the resolve kernel,
``nms_mask`` and the eval step's propose, at the Swin-S bench scene.

Run on a GPU from the repository root::

    python scripts/time_nms.py [--tree DIR] [--label NAME]

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
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import numpy as np
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

    eval_step, grids, ori = cs.bench_eval_step(torch)
    _, obj, dl, _ = eval_step.forward(grids)
    nb, ns, nv, thresh = cs.capture_nms_problem(eval_step, obj, dl, ori)
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
    return dict(k3=k3, nms=nms, propose=prop)


if __name__ == "__main__":
    main()
