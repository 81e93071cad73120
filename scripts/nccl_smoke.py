#!/usr/bin/env python3
"""The port's multi-rank paths over NCCL, one rank a card, on four cards.

Run from the repository root on a machine with four NVIDIA GPUs (H100,
sm_90a) and the CUDA toolkit::

    python3 scripts/nccl_smoke.py [--cases a,c,b]

It raises where fewer than four CUDA devices are present: it never drops to
gloo or to fewer cards.  It prints each card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit``) and the links between them
(``nvidia-smi topo -m`` and ``nvlink --status``, where the machine allows
them, and the pairs with direct peer access), builds the kernels, then
runs, each rank on its own card (``ddp.launch(..., [cuda:0..3], "nccl", n_space=)``):

(a) data parallel at world 4: ``chip_smoke.py`` phase 25's Swin-S OBB RPN,
    Swin-S OBB FCOS (160^3, two scenes a rank, eight in all) and
    ``train_rcnn.sh``'s Swin-S OBB fine-tune (200x200x136, one scene a rank:
    eight scenes of its f32 step, ~18 GiB a pair, would leave one card no
    room for its one-process reference) train steps, f32 with TF32 off,
    against one process of the whole global batch on ``cuda:0`` within
    ``DDP_LIMITS``; the ranks bit-equal after the step; K1 and K2 24 a
    rank; the gradient all-reduce's ms (the Swin-S RPN's 248 MiB) and the
    step's ms at world 4 against one process of the global batch;
(b) the drivers as users run them: ``run_rpn --mode train --gpus 0-3`` with
    ``scripts/train.sh``'s flags (bf16, ``--batch_size 8``) on synthetic
    160^3 OBB scenes for one epoch of one step and its validation eval,
    then ``--mode eval --gpus 0-3`` of its ``model_best``, whose files
    must equal, byte for byte, one process's at ``--batch_size 1`` (the
    same batches: a scene a rank; phase 27's rule); then ``run_rpn_detect
    --fine_tune --gpus 0-3`` with ``scripts/train_rcnn.sh``'s flags
    (``--batch_size 4``: one 200x200x130 scene a rank; ``--pretrained``
    the RPN's ``model_best``) for two steps and its validation eval.  Each
    rank's launches are read around the driver's own launch of the ranks;
(c) the space axis: phases 32's, 33's and 34's eval and train cases at
    (n_data, n_space) = (1, 4) and (2, 2) against one process, by those
    phases' rules (at (2, 2) each data group evaluates the eval's one
    scene, and the train steps' two scenes go one to a data group).  At
    (1, 4) 160^3 leaves two ranks without windows at stage 3 (two window
    columns) and 208x208x144 likewise, so ``space.keep_graph_empty`` runs
    under NCCL; each rank's launches are a whole scene's less the blocks
    of its empty stages.  Each forward's exchanges (count, MiB, ms) and
    the peak GiB a rank are printed.

They run in the order (a), (c), (b) (``--cases`` names others, e.g.
``--cases b``).  The functions take the devices and the backend as
arguments, so that
``tests/test_torch_nccl_smoke_plan.py`` runs (a) and (c) on four gloo CPU
ranks at a small size (``config`` sets ``chip_smoke``'s case tables there;
CPU devices get no-op stand-ins for the ``torch.cuda`` calls of
``chip_smoke``'s functions, and expect no kernel launch).  The last line is
``{"ok": true, ...}``.  Imports no jax.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

N_CARDS = 4
# (a): scenes a rank by phase 25 case
DP_CASES = {"swin_s rpn obb": 2, "swin_s fcos obb": 2, "swin_s rcnn obb": 1}
DP_STEP_REPS = 2
# (c): (n_data, n_space), and chip_smoke's rank functions by phase
SPACE_LAYOUTS = ((1, 4), (2, 2))
SPACE_RANKS = (("_space_rank", "space"), ("_space_fcos_vgg_rank", "space33"),
               ("_space_rcnn_rank", "space34"))
# (b): ``scripts/train.sh``'s flags (its ``--batch_size 8`` apart) and the
# RCNN's global batch (``train_rcnn.sh``'s 2 does not split over 4 ranks)
TRAIN_SH = ["--dataset_name", "front3d", "--resolution", "160", "--backbone_type", "swin_s",
            "--lr", "3e-4", "--weight_decay", "1e-3", "--rpn_nms_thresh", "0.3",
            "--log_to_file", "--normalize_density", "--rotated_bbox", "--bf16"]
TRAIN_SH_BATCH = "8"
RCNN_BATCH = 4


def configure(config):
    """``chip_smoke``'s module settings (its case tables) from ``config``."""
    for k, v in (config or {}).items():
        setattr(cs, k, v)


def require_cards(torch, n=N_CARDS):
    """The ``n`` CUDA devices, or RuntimeError."""
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < n:
        raise RuntimeError(f"nccl_smoke needs {n} CUDA devices, one rank a card; "
                           f"{found} found")
    return [torch.device("cuda", i) for i in range(n)]


def card_report(torch):
    """Prints and returns each card's ``name, power.limit`` line; prints
    the links: ``nvidia-smi topo -m`` and ``nvidia-smi nvlink --status``
    (their output, or their exit code and error where the machine refuses
    them) and which pairs of cards reach each other's memory directly
    (``torch.cuda.can_device_access_peer``)."""
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    for i, line in enumerate(cards):
        print(f"[card {i}] {line}", flush=True)
    for cmd in (["nvidia-smi", "topo", "-m"], ["nvidia-smi", "nvlink", "--status"]):
        res = subprocess.run(cmd, capture_output=True, text=True)
        print(f"[topology] {' '.join(cmd)} (exit {res.returncode}):\n"
              + (res.stdout + res.stderr).rstrip(), flush=True)
    n = torch.cuda.device_count()
    peers = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(n)]
             for i in range(n)]
    print(f"[topology] peer access (row: from card, column: to card): {peers}", flush=True)
    return cards


def cpu_stand_ins(torch, device):
    """On a CPU device (the CPU rehearsal), no-op stand-ins for the
    ``torch.cuda`` calls that ``chip_smoke``'s functions make."""
    if device.type == "cpu":
        torch.cuda.synchronize = lambda *a: None
        torch.cuda.reset_peak_memory_stats = lambda *a: None
        torch.cuda.max_memory_allocated = lambda *a: 0
        torch.cuda.empty_cache = lambda: None


def _on_rank(config, devices, calls):
    """A rank: ``chip_smoke``'s rank functions ``calls`` (name, work
    directory, keywords), in order, on this rank's device of ``devices``."""
    import torch

    from nerf_rpn_tpu_torch.parallel import ddp

    dev = devices[ddp.rank()]
    cpu_stand_ins(torch, dev)
    if dev.type == "cpu":  # ranks of a rehearsal share the host's cores
        torch.set_num_threads(1)
    configure(config)
    for name, work, kw in calls:
        getattr(cs, name)(work, dev, **kw)


def _f32(torch):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# (a) Data parallel
# ---------------------------------------------------------------------------


def _init_method(rendezvous, tag):
    """A ``file://`` rendezvous under ``rendezvous`` (a directory), or None:
    a TCP one at a free port (``ddp.launch``)."""
    return None if rendezvous is None else f"file://{rendezvous}/rendezvous_{tag}"


def data_parallel(torch, devices, backend, work, config=None, per_rank=None, card="",
                  step_reps=DP_STEP_REPS, rendezvous=None):
    """(a): each case of ``per_rank`` (case -> scenes a rank) in one process
    on ``devices[0]`` at the global batch (world x scenes a rank; its ms a
    step over ``step_reps`` after it), then one rank a device over
    ``backend`` (``chip_smoke._ddp_rank``: other ranks' weights shifted
    and broadcast back, one step, the ms of ``step_reps`` more; 0: not
    timed), each rank on its block; ``rendezvous``: a directory for a
    ``file://`` rendezvous (default TCP).  Fails unless the ranks are
    bit-equal (weights and metrics), their readings within ``DDP_LIMITS``
    of the one process's, the counts equal, K1 and K2 one a Swin block a
    rank (none on the CPU).  Prints a row a case after ``card``; returns
    them."""
    import numpy as np

    from nerf_rpn_tpu_torch.models.swin import SWIN_VARIANTS
    from nerf_rpn_tpu_torch.parallel import ddp
    from nerf_rpn_tpu_torch.train.state import TrainState

    per_rank = per_rank or DP_CASES
    cases = (config or {}).get("DDP_CASES", cs.DDP_CASES)
    # the ranks run these cases alone
    config = {**(config or {}), "DDP_CASES": {n: cases[n] for n in per_rank}}
    configure(config)
    cpu_stand_ins(torch, devices[0])
    os.makedirs(work, exist_ok=True)
    _f32(torch)
    world, dev = len(devices), devices[0]
    refs = {}
    for name, k in per_rank.items():
        model, batch, sample, run = cs._ddp_case(torch, name, dev, scenes=k * world)
        torch.cuda.reset_peak_memory_stats()
        metrics, state = cs._ddp_step(torch, model, run, batch, sample)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = None
        if step_reps:
            timed = TrainState(model, cs.DDP_LR, 10)
            ms = cs._ms(torch, lambda: run(model, timed, batch, sample), step_reps)
        refs[name] = (metrics, state, {n for n, _ in model.named_parameters()}, peak, ms)
        del model, batch, sample
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ddp.launch(_on_rank, (config, devices, [("_ddp_rank", work, {
        "per_rank": per_rank, "step_reps": step_reps})]), devices, backend,
               _init_method(rendezvous, "dp"))
    ranks_s = time.perf_counter() - t0
    ranks = cs._load_ranks(torch, work, "ddp")
    if len(ranks) != world:
        cs.fail(f"data parallel: {len(ranks)} ranks wrote results, {world} ran")
    rows, bad = [], []
    for name, (metrics, state, params, peak, ms) in refs.items():
        entries = [rank[name] for rank in ranks]
        if not all(e["broadcast_equal"] for e in entries):
            bad.append(f"{name}: broadcast_module_ left the ranks' weights unequal")
        if not all(e["ranks_equal"] and e["metrics"] == entries[0]["metrics"] for e in entries):
            bad.append(f"{name}: the ranks differ after the step")
        blocks = sum(SWIN_VARIANTS.get(cs.DDP_CASES[name]["backbone"], {"depths": ()})["depths"])
        blocks *= dev.type == "cuda"
        want = {"window_attention_fwd": blocks, "window_attention_bwd": blocks}
        bad += [f"{name} rank {r}: launches {e['launches']}, expected {want}"
                for r, e in enumerate(entries) if e["launches"] != want]
        got = entries[0]["metrics"]
        counts = [c for c in metrics if c.endswith("_rois") or c == "dropped_positives"]
        if set(got) != set(metrics) or any(got[c] != metrics[c] for c in counts):
            bad.append(f"{name}: metrics {got} against {metrics}")
            continue
        read, flips = cs.step_readings(got, entries[0]["state"], metrics, state, params)
        limits = cs.DDP_LIMITS["float32"]
        bad += [f"{name}: {c} {v} over its limit {limits[c]}" for c, v in read.items()
                if not (np.isfinite(v) and v <= limits[c])]
        row = {"case": name, "world": world, "backend": backend,
               "scenes": per_rank[name] * world, "scenes_a_rank": per_rank[name],
               "readings": read, "limits": limits, "flipped_steps": flips,
               "loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
               "step_ms_per_rank": [e.get("step_ms") for e in entries],
               "one_process_step_ms": ms, "one_process_peak_gib": peak,
               "rank_peak_gib": [e["peak_gib"] for e in entries],
               "launches_per_rank": entries[0]["launches"],
               **{c: got[c] for c in counts}}
        if "grad_all_reduce_ms" in entries[0]:
            row.update(grad_mib=entries[0]["grad_mib"],
                       grad_all_reduce_ms=[e["grad_all_reduce_ms"] for e in entries])
        print(f"[data parallel {backend} x{world}] {card}:", json.dumps(row), flush=True)
        rows.append(row)
    print(f"[data parallel {backend} x{world}] the ranks' part: {ranks_s:.1f} s", flush=True)
    if bad:
        cs.fail("data parallel: " + "; ".join(bad))
    return rows


# ---------------------------------------------------------------------------
# (b) The drivers
# ---------------------------------------------------------------------------


def _counted(out, fn, *fn_args):
    """A rank of a driver's own launch: ``fn(*fn_args)``, the launch counts
    set to 0 before it and written to ``<out>_rank<r>.json`` after it."""
    import torch

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.parallel import ddp

    kernels.reset_counts()
    try:
        return fn(*fn_args)
    finally:
        torch.cuda.synchronize()
        with open(f"{out}_rank{ddp.rank()}.json", "w") as f:
            json.dump(kernels.counts(), f)


@contextlib.contextmanager
def counted_launches(out):
    """Inside: every ``ddp.launch`` (the one ``ddp.run_driver`` makes for
    ``--gpus``) runs its ranks through ``_counted``, which writes each
    rank's launches under ``out``."""
    from nerf_rpn_tpu_torch.parallel import ddp

    real = ddp.launch

    def launch(fn, fn_args, devices, backend, init_method=None, n_space=1):
        return real(_counted, (out, fn, *fn_args), devices, backend, init_method, n_space)

    ddp.launch = launch
    try:
        yield
    finally:
        ddp.launch = real


def _read_counts(out, world):
    counts = []
    for r in range(world):
        with open(f"{out}_rank{r}.json") as f:
            counts.append(json.load(f))
    return counts


def write_rcnn_rois(np, data, rois, resolution, n_neg=24, seed=0):
    """Per scene of ``data`` (OBB gt ``.npy`` files in a ``resolution``
    grid): RoIs -- each gt box jittered four times and ``n_neg`` random OBBs
    -- and their levels (``--remap``'s mapper at the canonical scale 64) in
    ``rois``, the stage-1 proposal files that ``run_rpn_detect`` reads."""
    from nerf_rpn_tpu_torch.ops.roi_align import map_rois_to_levels_np

    os.makedirs(rois, exist_ok=True)
    rng = np.random.default_rng(seed)
    for fn in sorted(os.listdir(data)):
        if not fn.endswith(".npy"):
            continue
        gt = np.load(os.path.join(data, fn)).astype(np.float32)
        pos = np.repeat(gt, 4, 0)
        pos[:, :6] += rng.uniform(-2, 2, (len(pos), 6)).astype(np.float32)
        ctr = rng.uniform(0.1, 0.9, (n_neg, 3)) * np.asarray(resolution)
        neg = np.concatenate([ctr, rng.uniform(10, 40, (n_neg, 3)),
                              rng.uniform(-1.5, 1.5, (n_neg, 1))], 1).astype(np.float32)
        boxes = np.concatenate([pos, neg])
        np.savez(os.path.join(rois, fn[:-4] + ".npz"), proposals=boxes,
                 level_indices=map_rois_to_levels_np(boxes, 0, 3, canonical_scale=64))


def driver_argvs(work, gpus):
    """(b)'s driver arguments: ``{"rpn data": dir, "rcnn data": dir, "rpn
    train": argv, "rpn eval": argv (without ``--gpus`` and the batch size),
    "rcnn train": argv}``."""
    rpn = os.path.join(work, "data160_obb")
    rcnn = os.path.join(work, "data200_obb")
    data = ["--features_path", rpn, "--boxes_path", rpn,
            "--dataset_split", os.path.join(rpn, "split.npz"), "--device", "cuda"]
    ckpt = os.path.join(work, "rpn_train", "model_best")
    rcnn_flags = list(cs.RCNN_TRAIN_FLAGS)
    rcnn_flags[rcnn_flags.index("--batch_size") + 1] = str(RCNN_BATCH)
    return {
        "rpn data": rpn, "rcnn data": rcnn,
        "rpn train": ["--mode", "train", *TRAIN_SH, "--batch_size", TRAIN_SH_BATCH, *data,
                      "--num_epochs", "1", "--log_interval", "1", "--eval_interval", "1",
                      "--save_path", os.path.join(work, "rpn_train"), "--gpus", gpus],
        "rpn eval": ["--mode", "eval", *TRAIN_SH, *data, "--checkpoint", ckpt,
                     "--output_proposals"],
        "rcnn train": ["--mode", "train", *cs._rcnn_common(rcnn, os.path.join(rcnn, "rois"),
                                                           os.path.join(work, "rcnn_train")),
                       *rcnn_flags, "--pretrained", ckpt, "--num_epochs", "1",
                       "--log_interval", "1", "--eval_interval", "1", "--gpus", gpus],
    }


def drivers(torch, work, gpus, card=""):
    """(b): the three driver runs with ``--gpus``; fails unless each writes
    its checkpoint, the eval's files equal one process's at batch 1 byte
    for byte, and each rank's launches are one train step's, eval batch's
    and scene's (``chip_smoke``'s tables).  Prints the seconds of each run
    and each rank's launches after ``card``."""
    import numpy as np

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.cli import run_rpn, run_rpn_detect
    from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_dataset
    from nerf_rpn_tpu_torch.parallel import ddp

    world = len(ddp.parse_gpus(gpus))
    argv = driver_argvs(work, gpus)
    write_synthetic_dataset(argv["rpn data"], n_train=int(TRAIN_SH_BATCH), n_val=world,
                            n_test=world, resolution=(160,) * 3, seed=1, rotated=True,
                            box_size=(16.0, 40.0))
    write_synthetic_dataset(argv["rcnn data"], n_train=2 * RCNN_BATCH, n_val=world, n_test=0,
                            resolution=(200, 200, 130), seed=3, rotated=True,
                            box_size=(20.0, 50.0))
    write_rcnn_rois(np, argv["rcnn data"], os.path.join(argv["rcnn data"], "rois"),
                    (200, 200, 130))
    lines, bad = [], []

    def run(path, cli, args, want):
        out = os.path.join(work, path.replace(" ", "_"))
        t0 = time.perf_counter()
        with counted_launches(out):
            cli.main(args)
        seconds = time.perf_counter() - t0
        counts = _read_counts(out, world)
        for r, c in enumerate(counts):
            if {k: c[k] for k in want} != want:
                bad.append(f"{path} rank {r}: launches {c}, expected {want}")
        lines.append({"path": path, "seconds": seconds, "launches_per_rank": counts})

    step = {"window_attention_fwd": 24, "window_attention_bwd": 24}
    scene = cs.eval_launches(1, 1, rotated=True)
    run("rpn train", run_rpn, argv["rpn train"],
        {k: scene[k] + step.get(k, 0) for k in scene})
    save = os.path.join(work, "rpn_train")
    for name in ("model_best", "epoch_1"):
        if not os.path.isfile(os.path.join(save, name)):
            bad.append(f"run_rpn --mode train --gpus {gpus}: rank 0 wrote no {name}")
    if not any(n.endswith(".log") for n in os.listdir(save)):
        bad.append(f"run_rpn --mode train --gpus {gpus}: no --log_to_file log")
    eval_out = os.path.join(work, "rpn_eval")
    run("rpn eval", run_rpn, [*argv["rpn eval"], "--batch_size", TRAIN_SH_BATCH, "--gpus",
                              gpus, "--save_path", eval_out], scene)
    one = os.path.join(work, "rpn_eval_one")
    kernels.reset_counts()
    t0 = time.perf_counter()
    run_rpn.main([*argv["rpn eval"], "--batch_size", "1", "--save_path", one])
    torch.cuda.synchronize()
    lines.append({"path": "rpn eval, one process, batch 1", "seconds": time.perf_counter() - t0,
                  "launches": kernels.counts()})
    cs.check_launches(kernels.counts(), cs.eval_launches(world, world, rotated=True),
                      "rpn eval, one process, batch 1")
    n = cs.same_files(eval_out, one, f"run_rpn --mode eval --gpus {gpus} against one process")
    lines.append({"path": "rpn eval files byte-equal", "files": n})
    run("rcnn train", run_rpn_detect, argv["rcnn train"],
        {"window_attention_fwd": 48 + 12, "window_attention_bwd": 48, "ln_partition_qkv": 24,
         "fused_mlp_block": 24, "fused_window_attention": 12, "nms_resolve": 1,
         "aabb_suppression_graph": 0})
    if not os.path.isfile(os.path.join(work, "rcnn_train", "model_best")):
        bad.append(f"run_rpn_detect --gpus {gpus}: rank 0 wrote no model_best")
    for line in lines:
        print(f"[drivers --gpus {gpus}] {card}:", json.dumps(line), flush=True)
    if bad:
        cs.fail("drivers: " + "; ".join(bad))
    return lines


# ---------------------------------------------------------------------------
# (c) The space axis
# ---------------------------------------------------------------------------


def space_axis(torch, devices, backend, work, config=None, layouts=SPACE_LAYOUTS, card="",
               rendezvous=None):
    """(c): phases 32-34's one-process references on ``devices[0]`` (their
    evals, times and phase 25's train steps at batch 2), then for each
    ``(n_data, n_space)`` of ``layouts`` one rank a device over
    ``backend`` running phases 32's, 33's and 34's rank functions, held by
    their checks (each rank's launches a whole scene's or step's less the
    blocks of its stages without windows; none on the CPU).  The checks
    print the readings, peaks and exchanges after ``card``; returns the
    launches by path.  ``rendezvous`` as ``data_parallel``'s."""
    from nerf_rpn_tpu_torch.parallel import ddp

    configure(config)
    cpu_stand_ins(torch, devices[0])
    _f32(torch)
    dev = devices[0]
    refs, alone = cs.space_eval_references(torch, dev)
    refs33 = cs.space33_references(torch, dev)
    ref34 = cs.space34_references(torch, dev)
    train_refs = {}
    for name in (cs.DDP_TIMED, cs.SPACE_FCOS_TRAIN, cs.SPACE_RCNN):
        model, batch, sample, run = cs._ddp_case(torch, name, dev)
        torch.cuda.reset_peak_memory_stats()
        metrics, state = cs._ddp_step(torch, model, run, batch, sample)
        train_refs[name] = (metrics, state, {n for n, _ in model.named_parameters()},
                            torch.cuda.max_memory_allocated() / 2 ** 30)
        del model, batch, sample
        torch.cuda.empty_cache()
    paths = {}
    for n_data, n_space in layouts:
        w = os.path.join(work, f"{n_data}x{n_space}")
        calls = [(fn, os.path.join(w, sub), {}) for fn, sub in SPACE_RANKS]
        t0 = time.perf_counter()
        ddp.launch(_on_rank, (config, devices, calls), devices, backend,
                   _init_method(rendezvous, f"{n_data}x{n_space}"), n_space=n_space)
        tag = f"space {backend} {n_data}x{n_space}"
        print(f"[{tag}] the ranks' part: {time.perf_counter() - t0:.1f} s", flush=True)
        paths.update(cs.check_space_axis(torch, w, refs, train_refs, [alone], card,
                                         f"{tag} rpn"))
        paths.update(cs.check_space_fcos_vgg(torch, w, refs33, train_refs, [alone], card,
                                             f"{tag} fcos vgg"))
        paths.update(cs.check_space_rcnn(torch, w, ref34, train_refs, card, f"{tag} rcnn"))
    return paths


def main(argv=None) -> None:
    import argparse

    import torch

    p = argparse.ArgumentParser(description="the port's multi-rank paths over NCCL on four "
                                "cards")
    p.add_argument("--cases", default="a,c,b",
                   help="which of (a) data parallel, (b) the drivers, (c) the space axis to "
                   "run, in this order (default: a,c,b)")
    cases = p.parse_args(argv).cases.split(",")
    devices = require_cards(torch)
    cards = card_report(torch)
    from nerf_rpn_tpu_torch import kernels

    print(f"[build] kernels built and loaded in {kernels.build_all():.2f} s", flush=True)
    card = "; ".join(cards)
    gpus = f"0-{N_CARDS - 1}"
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        os.makedirs(os.path.join(work, "drivers"))
        runs = {"a": ("(a) data parallel", lambda: data_parallel(
                    torch, devices, "nccl", os.path.join(work, "dp"), card=card)),
                "c": ("(c) space axis", lambda: space_axis(
                    torch, devices, "nccl", os.path.join(work, "space"), card=card)),
                "b": ("(b) drivers", lambda: drivers(
                    torch, os.path.join(work, "drivers"), gpus, card))}
        for name, fn in (runs[c] for c in cases):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            print(f"[phase] {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"ok": True, "seconds": time.perf_counter() - t_all, "cards": cards,
                      "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
