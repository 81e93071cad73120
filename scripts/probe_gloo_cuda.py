"""Which gloo collectives carry CUDA tensors between two ranks on one card.

Run on a GPU from the repository root::

    python scripts/probe_gloo_cuda.py

For each of ``all_reduce``, ``all_gather``, ``broadcast`` and
``send``/``recv``, two gloo ranks (spawned processes, both on ``cuda:0``)
exchange a CUDA tensor and check the values they get; each probe runs in a
process of its own under a time limit, so a crash or a hang reads as a
failure and the other probes still run.  Prints the card and one JSON line,
``{op: "ok" | the failure}``.  The space axis (``parallel/space.py``)
exchanges rows with ``all_gather``; this says whether gloo, the one-card
check's backend, could carry point-to-point sends instead.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

OPS = ("all_reduce", "all_gather", "broadcast", "send_recv")


def _rank(rank: int, op: str, port: int) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    try:
        x = torch.full((1024,), float(rank + 1), device="cuda")
        if op == "all_reduce":
            dist.all_reduce(x)
            want = torch.full_like(x, 3.0)
        elif op == "all_gather":
            out = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(out, x)
            x, want = torch.cat(out), torch.cat([torch.full_like(x, 1.0), torch.full_like(x, 2.0)])
        elif op == "broadcast":
            dist.broadcast(x, 0)
            want = torch.full_like(x, 1.0)
        else:
            if rank == 0:
                dist.send(x, 1)
                want = x.clone()
            else:
                dist.recv(x, 0)
                want = torch.full_like(x, 1.0)
        torch.cuda.synchronize()
        if not torch.equal(x, want):
            raise SystemExit(f"{op}: wrong values on rank {rank}")
    finally:
        dist.destroy_process_group()


def _probe(op: str) -> None:
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from nerf_rpn_tpu_torch.parallel.ddp import free_port

    torch.multiprocessing.spawn(_rank, args=(op, free_port()), nprocs=2, join=True)


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--op":
        _probe(sys.argv[2])
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    out = {}
    for op in OPS:
        try:
            res = subprocess.run([sys.executable, __file__, "--op", op], capture_output=True,
                                 text=True, timeout=120)
            out[op] = "ok" if res.returncode == 0 else (
                f"exit {res.returncode}: " + (res.stderr.strip().splitlines() or [""])[-1][:300])
        except subprocess.TimeoutExpired:
            out[op] = "hung (120 s)"
    print(f"[gloo on CUDA tensors] {card}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
