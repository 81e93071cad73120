#!/usr/bin/env python3
"""GPU smoke run of the torch port (``nerf_rpn_tpu_torch``) on one card.

Run from the repository root on a machine with one NVIDIA GPU (sm_90a,
H100) and the CUDA toolkit::

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``; any failure exits
nonzero before the result lines:

1. require CUDA, print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``nerf_rpn_tpu_torch/csrc`` (timed), with
   ``nvcc -Xptxas -v``'s registers, static shared memory and spills of the
   K1/K4, K2, K3 and resolve, K5 and K6 kernels printed beside the build;
3. kernel K1 (window attention) against its plain twin at the shapes the
   main path runs it -- the four stages of the Swin-S eval bench shape
   without a mask (W x H = 1521x3, 245x6, 48x12, 8x24) and the train stage
   0 with the real shift mask (2000x3, mask (1000, 64, 64)), f32 (TF32
   off) and bf16 -- with times and each row's head group G;
4. kernel K2 (window-attention backward: a block of 4 warps per (run of
   windows, head) walking its run in order with the next window's
   16-byte cp.async copies in flight, the five products on bf16
   ``mma.sync`` (3xTF32 for f32), dbias kept per block and summed over
   runs in a fixed order) against its twin at the four Swin-S train
   shapes (160^3, batch 2), f32 and bf16, masked and not, with times,
   each row's number of runs and bit-equal results over two runs; the
   autograd function (K1 forward, K2 backward) against autograd through
   K1's twin;
5. kernel K3 (AABB suppression graph) against its twin, bit for bit, on
   4 x 2560 boxes (dense overlaps plus zero-volume padding, IoU 0.3); then
   the bench scene's NMS problem (the Swin-S bf16 eval step at 208x208x144
   with random weights, one problem per FPN level): ``eval_step.propose``
   under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), K3
   and the resolve kernel (greedy keep-set from the graph, one block per
   problem) against their twins, the twin's sweep count, the resolve
   kernel against the twin on a depth-2560 chain, and the times of the
   resolve kernel and of the whole ``nms_mask`` against the sweep loop;
6. kernels K4 (window attention with the shift-mask pattern table), K5
   (LayerNorm + pad + shift + partition + qkv) and K6 (the MLP half of a
   block) against their twins at the four stages of the Swin-S eval bench
   shape (208x208x144: tokens 52x52x36, 26x26x18, 13x13x9, 7x7x5, the last
   three padded, every shift on), f32 and bf16, with times (K4 with its
   head group G; K5 and K6, given their weights as the model gives them,
   ``Linear.weight.t()``, with their plans and blocks: K5 R tokens and G
   tiles of BN columns a block, weight k-chunk BK; K6 R tokens and a
   hidden slice of Hd / S a block, column tile BN, weight k-chunk BK);
7. a small slice (swin_t, 64^3, f32) on the GPU against the same weights
   on the CPU (plain twins): head outputs, and proposals from the same
   head outputs;
8. a small train step (swin_t, 64^3, f32, batch 2) on the GPU against the
   CPU: same weights, the same injected anchor sample, drop-path off;
   loss terms and every gradient leaf;
9. the eval path: 3 synthetic Hypersim-layout scenes at 200x200x130
   through ``run_rpn --mode eval`` (Swin-S, bf16), then
   ``--mode benchmark``, with the launch counts read around each: K1, K3,
   K4, K5 and K6 must run, K5 and K6 once per block, K4 and K1 once per
   shifted and unshifted block, K3 and the resolve kernel once per scene;
10. the train path: 4 train and 2 validation synthetic scenes at 160^3
   through ``run_rpn --mode train`` (Swin-S, bf16, batch 2, one epoch,
   validation eval, checkpoints), with every kernel's launch count read
   around it (K2 once per block and step: 24 a step);
   ``--mode eval --checkpoint <save>/model_best``; then 20
   timed train steps at that shape (ms/step with CUDA events, peak device
   memory);
11. OBB NMS (``--rotated_bbox``): the bench scene's problem of the rotated
   Swin-S bf16 eval step (4 x 2560, decoded as OBBs from its head
   outputs): the rotated graph (plain torch) and the resolve kernel on the
   card against ``nms_mask`` on CPU copies (equal keep-sets), the resolve
   kernel against its sweep twin on that graph, ``nms_mask``'s device ms,
   the gated pairs, the host syncs counted under
   ``torch.cuda.set_sync_debug_mode("warn")`` and the kernels it launched
   (the resolve kernel once, K3 never);
12. the OBB eval path: ``run_rpn --mode benchmark --rotated_bbox`` (Swin-S,
   bf16, 208x208x144): ms a scene, launches a scene (K5 24, K6 24, K4 12,
   K1 12, resolve 1, K3 0);
13. the OBB train path, ``scripts/train.sh``'s configuration:
   ``run_rpn --mode train --rotated_bbox`` on synthetic OBB scenes at
   160^3 (Swin-S, bf16, batch 2, smooth-L1), ``--mode eval --checkpoint``,
   then 20 timed OBB train steps (K1 and K2 24 a step);
14. FCOS NMS: the cross-level problem of the Swin-S bf16 FCOS eval step
   at 160^3 (``run_fcos --mode benchmark``'s scene, random weights): one
   scene of 2500 + 2500 + 1000 + 125 boxes, padded to Np = 6144, as AABBs
   and as OBBs.  The keep-sets on the card equal the CPU's; K3 (AABB) and
   the resolve kernel equal their twins at Np = 6144, with their ms; the
   OBB graph's gated pairs and host syncs (``set_sync_debug_mode("warn")``)
   and each ``nms_mask`` call's device-busy ms (``torch.profiler``);
15. the FCOS eval path: ``run_fcos --mode benchmark`` (Swin-S, bf16,
   ``test_fcos.sh``'s head flags, 160^3) with ``--rotated_bbox`` and
   without: forward, propose and whole ms a scene, and the launches a
   scene (K5 24, K6 24, K4 12, K1 12, resolve 1; K3 1 for AABBs, 0 for
   OBBs);
16. the FCOS train path, ``scripts/train_fcos.sh``'s configuration
   (Swin-S, bf16, OBBs, ``--iou_loss_type iou``, ``--norm_reg_targets
   --centerness_on_reg``, radius 1.5, batch 2 a card): ``run_fcos --mode
   train`` on the synthetic 160^3 OBB scenes of phase 13, finite loss
   terms, no dropped positives, K1 and K2 24 a step; then ``--mode eval
   --checkpoint <save>/model_best --output_proposals --save_level_index``;
17. 20 timed FCOS train steps (ms a step, peak GiB);
18. the ResNet / VGG small slice: ``resnet_tiny`` and ``vgg_AF`` (the
   ``input_size >= 160`` stem) at 64^3, f32, the same weights and running
   statistics (not 0 / 1) on the card and on the CPU: eval head outputs,
   proposals from the same head outputs (as sets: rows whose sigmoids
   differ by an ulp may trade places), and one RPN train step at batch 2
   with one injected anchor sample, in f64 and in f32 (loss terms,
   ``grad_norm``, every gradient leaf, the updated running statistics;
   ``CNN_TRAIN_STEP_LIMITS``);
19. the ResNet / VGG eval paths: ``run_rpn --mode benchmark --bf16
   --pad_multiple 16`` with ``resnet``, ``vgg_AF`` and ``vgg_EF`` at
   208x208x144 (``bench.py``'s three CNN rows) and ``run_fcos --mode
   benchmark --backbone_type resnet`` at 160^3: forward, propose and whole
   ms a scene, launches a scene K3 1, resolve 1, every Swin kernel 0;
20. the ResNet train path: ``run_rpn --mode train --backbone_type resnet
   --bf16`` on phase 10's 160^3 scenes (batch 2, one epoch, validation,
   checkpoints), ``--mode eval --checkpoint <save>/model_best`` with its
   restored running statistics equal to the saved ones, then 20 timed
   train steps (ms a step, peak GiB; no hand kernel a step);
21. the quality gate on the card (``nerf_rpn_tpu_torch.cli.quality_gate``,
   ``rpn_aabb`` and ``fcos_obb``: resnet_tiny trained from scratch for 60
   epochs on synthetic 32^3 scenes through ``run_rpn`` / ``run_fcos``),
   under torch's deterministic algorithms: AP@25, AP@50, Recall@25, the
   validation curve and the seconds of each run; seeds 0, 1, ... run until
   a combo has cleared the script's gates as often as the JAX package's
   own gate does on seeds 0-5, and at least once (``JAX_GATE_PASSES``);
   the phase fails if it does not; and the ``rcnn`` combo
   (``resnet_tiny`` fine-tuned for 40 epochs through ``run_rpn_detect`` on
   the scenes' generated RoIs; AP@25, AP@50 and the classification
   accuracy), the same way; the combos run at once, a process each;
22. the RCNN small slice, card against CPU, same weights (f32, TF32 off):
   the features mode at ``train_rcnn.sh``'s head (256 channels, 3^3,
   ``--is_add_layer --is_flatten``), AABB and OBB, on random FPN levels of
   a 200x200x136 scene pair -- pooled features, eval scores and refined
   boxes, the filter's keep-sets and orders on the same inputs (equal);
   fine-tune ``resnet_tiny`` at 32^3 -- eval outputs, and one train step
   with an injected RoI sample in f64 and in f32 (phase 18's limits);
23. ``train_rcnn.sh``'s path: synthetic OBB scenes at 200x200x130 (4
   train, 2 validation, 2 test), their RoIs and FPN levels from ``run_rpn
   --mode eval --rotated_bbox --save_results --output_all`` with phase
   13's OBB ``model_best``, ``run_rpn_detect --mode train`` with every
   flag of the script (Swin-S fine-tuned from that checkpoint through
   ``--pretrained``, f32, one epoch, validation, checkpoints; the sampled
   RoIs' fg / bg counts), ``--mode eval --checkpoint <save>/model_best
   --output_proposals``, with the launches asserted (a train step K1 24,
   K2 24; an eval batch K5 24, K6 24, K4 12, K1 12, resolve once a scene,
   K3 never); then 20 timed fine-tune train steps (ms a step, peak GiB)
   and the eval a scene at batch 1 by part (backbone, RoI align, head,
   filter; device-busy ms);
24. the features mode: ``run_rpn_detect`` without ``--fine_tune`` on
   phase 23's saved levels (Swin-S, 256 channels), OBB and AABB (the
   enclosing boxes), on 2 train, 1 validation and 2 test scenes, one epoch
   and an eval each; then RoI align alone at 2 x 1024 RoIs: device ms
   against the bound of the feature rows its samples touch;
25. data parallel (``parallel/ddp.py``): (a) four train steps at full
   width in f32 with TF32 off -- ``train.sh``'s Swin-S OBB RPN, the
   ``resnet`` RPN (BatchNorm and its running statistics) and
   ``train_fcos.sh``'s Swin-S OBB FCOS at 160^3, ``train_rcnn.sh``'s
   Swin-S fine-tune at 200x200x136 -- and the ``resnet`` RPN in f64
   besides, in this process at batch 2, then on
   two ranks of one scene each on the same card (gloo, which carries CUDA
   tensors; NCCL refuses two ranks on one device), with the same weights
   (rank 1's shifted, then ``broadcast_module_``), the same anchor or RoI
   sample and drop-path off: the ranks bit-equal to each other, their
   loss terms, norms, updated parameters (the share of flipped AdamW
   steps) and running statistics within ``DDP_LIMITS`` of the one
   process's, K1 and K2 24 a Swin step a rank,
   and the gradient all-reduce's ms; (b) ``run_rpn --gpus 0`` (NCCL, a
   group of one) on phase 10's path with phase 10's launches, then
   ``run_fcos --gpus 0`` and ``run_rpn_detect --gpus 0`` for two steps
   each, ``model_best`` written by rank 0; (c) the RPN train step in a
   group of one and alone, in turns.  One card shows no scaling across
   cards.

Times are device ms per call from CUDA events around 20 back-to-back
calls queued behind a sleep kernel (so the host's launch gaps do not
count), in turns plain, kernel, kernel, plain; ``library_ms`` is one
PyTorch call computing the same function
(``F.scaled_dot_product_attention`` with the additive bias and mask for
K1 and K4, its autograd backward for K2), timed as a yardstick only.
``bound_ms`` is the least time of the same work on an H100 SXM (3.35 TB/s,
989 TFLOP/s bf16, 67 TFLOP/s f32): the larger of the bytes moved (each
input read once, each output written once) over the memory rate and the
operations over the peak rate for their type.

Each path (AABB eval, AABB train, OBB eval, OBB train, FCOS OBB and AABB
eval, FCOS train, the CNN eval paths, the ResNet train path, the RCNN
fine-tune and features paths, and phase 25's ``--gpus 0`` paths) runs
with the launch counts set to 0 just before it and read just after; a
kernel's ``launches`` in the record is its sum over them.  The last three
lines are the kernels' JSON record, the ``nvidia-smi`` line and ``{"ok":
true, "device": {...}}``.  Imports no jax.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

# one H100 SXM (NVIDIA data sheet): HBM rate and dense peaks by operand type
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# Swin-S eval bench shape 208x208x144: (stage, token grid, heads, C, batch)
EVAL_STAGES = [("stage0", (52, 52, 36), 3, 96, 1), ("stage1", (26, 26, 18), 6, 192, 1),
               ("stage2", (13, 13, 9), 12, 384, 1), ("stage3", (7, 7, 5), 24, 768, 1)]
# Swin-S FCOS eval at 160^3 (run_fcos --mode benchmark): the same, batch 1
FCOS_EVAL_STAGES = [("fcos stage0", (40, 40, 40), 3, 96, 1),
                    ("fcos stage1", (20, 20, 20), 6, 192, 1),
                    ("fcos stage2", (10, 10, 10), 12, 384, 1),
                    ("fcos stage3", (5, 5, 5), 24, 768, 1)]
# train_rcnn.sh's fine-tune eval at 200x200x136 (the collate's padding of
# 200x200x130): run_rpn_detect's batches of 2 scenes
RCNN_EVAL_STAGES = [("rcnn stage0", (50, 50, 34), 3, 96, 2),
                    ("rcnn stage1", (25, 25, 17), 6, 192, 2),
                    ("rcnn stage2", (13, 13, 9), 12, 384, 2),
                    ("rcnn stage3", (7, 7, 5), 24, 768, 2)]
# and one scene, as phase 23 times the eval by part; K5 and K6 only: K1's
# and K4's windows at batch 1 are EVAL_STAGES' (the same padded grids)
RCNN_SCENE_STAGES = [(f"rcnn scene {name[5:]}", s, h, c, 1)
                     for name, s, h, c, _ in RCNN_EVAL_STAGES]
# the fine-tune train step's padded token grids (batch 2), K2's stages
# 0-2; its stage 3 is the RPN train step's (8, 8, 8)
RCNN_TRAIN_PADS = [("rcnn stage0", (52, 52, 36), 3, 96), ("rcnn stage1", (28, 28, 20), 6, 192),
                   ("rcnn stage2", (16, 16, 12), 12, 384)]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_done(torch, name: str, t0: float) -> None:
    torch.cuda.synchronize()  # raises on a fault during the phase
    print(f"[phase] {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


_SLEEP_CYCLES_PER_MS = []


def _sleep_cycles_per_ms(torch) -> float:
    """Cycles of ``torch.cuda._sleep`` per device ms, measured once."""
    if not _SLEEP_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(10 ** 7 / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def time_one(torch, fn, reps=20, warmup=3):
    """Device ms per call of ``fn`` over ``reps`` back-to-back calls, with
    CUDA events.  The calls are queued behind a sleep kernel that lasts
    longer than the host takes to launch them, so the host's launch
    overhead between calls does not count (it does for a ``fn`` that
    synchronises)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    launch_ms = (time.perf_counter() - t0) * 1e3 / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_sleep_cycles_per_ms(torch) * (1.5 * reps * launch_ms + 0.1)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(torch, plain, kernel):
    """Device ms per call of each, measured in turns plain, kernel, kernel,
    plain with CUDA events."""
    p1, k1, k2, p2 = (time_one(torch, f) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(moved: int, ops: float, dtype: str) -> dict:
    """The least time of the work on the card: bytes over the memory rate
    or operations over the peak rate for their type, whichever is larger."""
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def close_enough(torch, got, want, dtype):
    """(max |got - want|, whether it is within the tolerance): f32 1e-5 of
    the output's scale (f32 sums in other orders); bf16 2 ulps of each
    row's largest magnitude (the same rounding points; a neighbouring-value
    rounding of an intermediate moves an output by a share of its row's
    scale where the row's terms cancel)."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if dtype == torch.float32:
        ok = err <= 1e-5 * (1.0 + want.float().abs().max().item())
    else:
        scale = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(2.0 ** -100)
        ok = (diff / torch.exp2(torch.floor(torch.log2(scale)) - 7)).max().item() <= 2.0
    return err, ok and math.isfinite(err)


def k2_close_enough(torch, dqkv, dbias, ref_q, ref_b, dtype):
    """(dqkv max|err|, dbias max|err|, whether both are within the
    tolerance) of a K2 result against its twin: dqkv f32 1e-5 of the
    output's scale (products summed in other orders), bf16 2 ulps of it (a
    probability or ds rounding to the neighbouring bf16 value moves an
    output by less); dbias 2e-5 of its scale (f32 sums over W windows in
    another order)."""
    scale = ref_q.float().abs().max().item()
    err = (dqkv.float() - ref_q.float()).abs().max().item()
    if dtype == torch.float32:
        lim = 1e-5 * (1.0 + scale)
    else:
        lim = 2.0 ** (math.floor(math.log2(scale)) - 6)
    b_err = (dbias - ref_b).abs().max().item()
    b_lim = 2e-5 * (1.0 + ref_b.abs().max().item())
    ok = math.isfinite(err) and err <= lim and math.isfinite(b_err) and b_err <= b_lim
    return err, b_err, ok


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def sdpa_views(qkv, heads):
    """q, k, v as (W, H, 64, D) views of a packed (W, 64, 3C) qkv."""
    w, n, c3 = qkv.shape
    return qkv.view(w, n, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4)


def start_ptxas_report(kernels, lib, workdir):
    """Start ``nvcc -Xptxas -v`` on ``csrc/<lib>.cu`` with the build's
    flags (a cubin into ``workdir``), beside the build."""
    cmd = [kernels.nvcc(), *kernels.nvcc_flags(lib), "-cubin", "-Xptxas", "-v",
           "-I", str(kernels.CSRC), "-o", os.path.join(workdir, f"{lib}.cubin"),
           str(kernels.CSRC / f"{lib}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def print_ptxas_report(proc, lib):
    """One line per kernel of the source: registers, static shared memory
    and spills, as ptxas reports them."""
    import re
    import shutil

    text = proc.communicate()[0]
    if proc.returncode != 0:
        fail(f"nvcc -Xptxas -v on {lib}.cu failed:\n{text}")
    entries, cur = {}, None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            cur = entries.setdefault(m.group(1), {})
        elif cur is not None and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(s.group(1)) if s else 0
    names = list(entries)
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True).stdout.splitlines()
    for name, info in zip(names, entries.values()):
        name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
        print("[ptxas]", json.dumps({"source": f"{lib}.cu", "kernel": name.split("(")[0],
                                     **info}), flush=True)


def check_window_attention(torch, dev):
    """K1 against its twin at the shapes the main path runs it: the four
    eval stages of the RPN and of the FCOS bench and the RCNN fine-tune
    eval's (batch 2) without a mask (the unshifted eval blocks); the train
    stage 0 with the real shift mask (160^3, batch 2: 2000 windows over a
    (1000, 64, 64) mask); the RCNN fine-tune train stage 0 (200x200x136,
    batch 2: 3042 windows) without and with its (1521, 64, 64) mask."""
    import torch.nn.functional as F

    from nerf_rpn_tpu_torch.models.swin import shift_attn_mask
    from nerf_rpn_tpu_torch.ops.window_attention import (
        head_group,
        tile_bytes,
        window_attention,
        window_attention_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(name, b * -(-s[0] // 4) * -(-s[1] // 4) * -(-s[2] // 4), heads, c, None)
             for name, s, heads, c, b in EVAL_STAGES + FCOS_EVAL_STAGES + RCNN_EVAL_STAGES]
    cases.append(("train stage0", 2000, 3, 96,
                  shift_attn_mask((40, 40, 40), (4, 4, 4), (2, 2, 2))))
    rcnn_mask = shift_attn_mask((52, 52, 36), (4, 4, 4), (2, 2, 2))
    cases += [("rcnn train stage0", 3042, 3, 96, m) for m in (None, rcnn_mask)]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, main = [], None
    for name, w, heads, c, mask_np in cases:
        mask = None if mask_np is None else torch.from_numpy(mask_np).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn((w, 64, 3 * c), generator=gen, device=dev).to(dtype)
            bias = 0.5 * torch.randn((heads, 64, 64), generator=gen, device=dev)
            out = window_attention(qkv, bias, mask, heads)
            ref = window_attention_reference(qkv, bias, mask, heads)
            err, ok = close_enough(torch, out, ref, dtype)
            if not ok:
                fail(f"K1 {name} {dtype} mask={mask is not None}: max|err| {err} "
                     f"outside the tolerance")
            ms, plain_ms = time_pair(
                torch, lambda: window_attention_reference(qkv, bias, mask, heads),
                lambda: window_attention(qkv, bias, mask, heads))
            q, k, v = sdpa_views(qkv, heads)
            am = bias[None] if mask is None else bias[None] + mask.repeat(
                w // mask.shape[0], 1, 1)[:, None]
            am = am.to(dtype)
            library_ms = time_one(
                torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am))
            del am
            d = c // heads
            group = head_group(w, heads, d, dtype)
            row = dict(stage=name, W=w, H=heads, C=c, dtype=dtype_name(dtype),
                       mask=mask is not None, G=group, smem_bytes=group * tile_bytes(d, dtype),
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       **bound(nbytes(qkv, bias, mask, out), 4 * w * heads * 64 * 64 * d,
                               dtype_name(dtype)))
            rows.append(row)
            print("K1", json.dumps(row), flush=True)
            if name == "train stage0" and dtype == torch.bfloat16:
                main = row
    return rows, main


def check_window_attention_backward(torch, dev):
    """K2 against its twin at the Swin-S train shapes (160^3, batch 2) and
    the RCNN fine-tune's (200x200x136, batch 2), with the real shift
    masks; dbias bit-equal over two runs; the autograd function (K1 + K2)
    against autograd through K1's twin."""
    import torch.nn.functional as F

    from nerf_rpn_tpu_torch.models.swin import shift_attn_mask
    from nerf_rpn_tpu_torch.ops.window_attention import (
        WindowAttention,
        backward_groups,
        backward_smem_bytes,
        window_attention_backward,
        window_attention_backward_reference,
        window_attention_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    # token grids 40^3, 20^3, 10^3 (padded to 12^3), 5^3 (padded to 8^3)
    stages = [("stage0", (40, 40, 40), 3, 96), ("stage1", (20, 20, 20), 6, 192),
              ("stage2", (12, 12, 12), 12, 384), ("stage3", (8, 8, 8), 24, 768),
              *RCNN_TRAIN_PADS]
    gen = torch.Generator(device=dev).manual_seed(3)
    rows, main = [], None
    for name, pad, heads, c in stages:
        mask_np = shift_attn_mask(pad, (4, 4, 4), (2, 2, 2))
        w = 2 * mask_np.shape[0]
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn((w, 64, 3 * c), generator=gen, device=dev).to(dtype)
            dout = torch.randn((w, 64, c), generator=gen, device=dev).to(dtype)
            bias = 0.5 * torch.randn((heads, 64, 64), generator=gen, device=dev)
            for masked in (False, True):
                mask = torch.from_numpy(mask_np).to(dev) if masked else None
                dqkv, dbias = window_attention_backward(qkv, dout, bias, mask, heads)
                dqkv2, dbias2 = window_attention_backward(qkv, dout, bias, mask, heads)
                if not (torch.equal(dbias, dbias2) and torch.equal(dqkv, dqkv2)):
                    fail(f"K2 {name} {dtype} mask={masked}: two runs differ")
                ref_q, ref_b = window_attention_backward_reference(
                    qkv, dout, bias, mask, heads)
                err, b_err, ok = k2_close_enough(torch, dqkv, dbias, ref_q, ref_b, dtype)
                if not ok:
                    fail(f"K2 {name} {dtype} mask={masked}: dqkv max|err| {err}, "
                         f"dbias {b_err}: outside the tolerance")
                ms, plain_ms = time_pair(
                    torch,
                    lambda: window_attention_backward_reference(qkv, dout, bias, mask, heads),
                    lambda: window_attention_backward(qkv, dout, bias, mask, heads))
                # the library yardstick: SDPA's autograd backward to qkv and bias
                lq = qkv.detach().requires_grad_()
                lb = bias.detach().requires_grad_()
                am = lb[None] if mask is None else lb[None] + mask.repeat(
                    w // mask.shape[0], 1, 1)[:, None]
                lo = F.scaled_dot_product_attention(*sdpa_views(lq, heads),
                                                    attn_mask=am.to(dtype))
                lo = lo.transpose(1, 2).reshape(w, 64, c)
                library_ms = time_one(torch, lambda: torch.autograd.grad(
                    lo, (lq, lb), dout, retain_graph=True))
                del lq, lb, am, lo
                d = c // heads
                row = dict(stage=name, W=w, H=heads, C=c, dtype=dtype_name(dtype),
                           mask=masked, runs=backward_groups(w, heads, d, dtype),
                           smem_bytes=backward_smem_bytes(d, dtype),
                           max_abs_err=err, dbias_max_abs_err=b_err,
                           ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           **bound(nbytes(qkv, dout, bias, mask, dqkv, dbias),
                                   10 * w * heads * 64 * 64 * d, dtype_name(dtype)))
                rows.append(row)
                print("K2", json.dumps(row), flush=True)
                if name == "stage0" and dtype == torch.bfloat16 and masked:
                    main = row

    # the autograd function against autograd through the twin (f32: the
    # point is the algorithm; the twin's own backward rounds nothing)
    mask = torch.from_numpy(shift_attn_mask((40, 40, 40), (4, 4, 4), (2, 2, 2))).to(dev)
    qkv = torch.randn((2000, 64, 288), generator=gen, device=dev).requires_grad_()
    bias = (0.5 * torch.randn((3, 64, 64), generator=gen, device=dev)).requires_grad_()
    cot = torch.randn((2000, 64, 96), generator=gen, device=dev)
    grads = []
    for fn in (lambda: WindowAttention.apply(qkv, bias, mask, 3),
               lambda: window_attention_reference(qkv, bias, mask, 3)):
        qkv.grad = bias.grad = None
        (fn() * cot).sum().backward()
        grads.append((qkv.grad.clone(), bias.grad.clone()))
    for (a, b), what in zip(zip(*grads), ("dqkv", "dbias")):
        err = (a - b).abs().max().item()
        if not err <= 1e-5 * (1.0 + b.abs().max().item()):
            fail(f"autograd K1+K2 vs twin autograd: {what} max|err| {err}")
    print(f"[K2] autograd function vs twin autograd (stage 0, f32, masked): ok", flush=True)
    return rows, main


def k3_boxes(torch, dev):
    """K3's timed problem: 4 x 2560 boxes, dense overlaps, 60 zero-volume
    padding rows each."""
    gen = torch.Generator(device=dev).manual_seed(1)
    p, n = 4, 2560
    lo = torch.rand((p, n, 3), generator=gen, device=dev) * 60.0
    size = 10.0 + torch.rand((p, n, 3), generator=gen, device=dev) * 50.0
    boxes = torch.cat([lo, lo + size], -1)
    boxes[:, n - 60:] = 0.0  # zero-volume padding rows
    return boxes


def graph_ops(p: int, n: int) -> int:
    """K3's operations: per box its volume (8 f32 ops); per pair i < j the
    intersection (12 ops + 2 products), union (2), IoU (1) and the
    threshold test (1)."""
    return p * (8 * n + 18 * n * (n - 1) // 2)


def check_suppression_graph(torch, dev):
    from nerf_rpn_tpu_torch.ops.nms_graph import (
        aabb_suppression_graph,
        aabb_suppression_graph_reference,
    )

    boxes = k3_boxes(torch, dev)
    p, n = boxes.shape[:2]
    out = aabb_suppression_graph(boxes, 0.3)
    ref = aabb_suppression_graph_reference(boxes, 0.3)
    if out.dtype != torch.int32 or out.shape != (p, n, n // 32):
        fail(f"K3 output {out.dtype} {tuple(out.shape)}")
    if not torch.equal(out, ref):
        fail(f"K3 differs from its twin in {(out != ref).sum().item()} words")
    if int((out != 0).sum()) == 0:
        fail("K3 graph is empty: the check would prove nothing")
    ms, plain_ms = time_pair(torch, lambda: aabb_suppression_graph_reference(boxes, 0.3),
                             lambda: aabb_suppression_graph(boxes, 0.3))
    row = dict(P=p, Np=n, max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
               **bound(nbytes(boxes, out), graph_ops(p, n), "float32"),
               set_bits=int(sum(bin(v & 0xffffffff).count("1")
                                for v in out.flatten().tolist())))
    print("K3", json.dumps(row), flush=True)
    return row


def bench_eval_step(torch, rotated=False):
    """The eval step of ``run_rpn --mode benchmark`` (Swin-S, bf16,
    200x200x130 padded to 208x208x144, random weights from seed 0; OBBs
    with ``rotated``), its random grid and the scene's size: ``(eval_step,
    grids, ori)``."""
    import numpy as np

    from nerf_rpn_tpu_torch.cli import run_rpn

    size = run_rpn.BENCH_SHAPE
    args = run_rpn.parse_args(["--mode", "benchmark", "--backbone_type", "swin_s", "--bf16",
                               "--resolution", str(size[0]), "--pad_multiple", "16",
                               *(["--rotated_bbox"] if rotated else [])])
    trainer = run_rpn.Trainer(args)
    shape = tuple(-(-s // 16) * 16 for s in size)
    eval_step = trainer.eval_step(shape)
    rng = np.random.default_rng(args.seed)
    grids = torch.from_numpy(rng.standard_normal((1, *shape, 4), np.float32)).to(
        trainer.device, trainer.dtype)
    ori = torch.tensor([size], dtype=torch.int32, device=trainer.device)
    return eval_step, grids, ori


def capture_nms_problem(eval_step, *heads, module=None):
    """``(boxes, scores, valid, iou_threshold)`` that one ``propose(*heads)``
    call hands the ``nms_mask`` of ``module`` (default ``models/rpn.py``:
    one problem per FPN level of the scene; ``models/fcos.py``: one
    cross-level problem per scene)."""
    if module is None:
        from nerf_rpn_tpu_torch.models import rpn as module

    seen, real = [], module.nms_mask

    def record(*args):
        seen.append(args)
        return real(*args)

    module.nms_mask = record
    try:
        eval_step.propose(*heads)
    finally:
        module.nms_mask = real
    return seen[0]


def triangle_words(svalid) -> int:
    """Graph words the resolve kernel must read: row j's ceil(j / 32) words
    below the diagonal, for the rows up to each problem's last valid one."""
    total = 0
    for row in svalid.cpu():
        idx = row.nonzero()
        rows = 0 if len(idx) == 0 else int(idx[-1]) + 1
        total += sum(-(-j // 32) for j in range(rows))
    return total


def chain_problem(torch, dev, n):
    """n unit boxes along x in score order, each overlapping only the next
    (IoU 1/3 > 0.3): greedy keeps every other one, the sweep loop needs ~n
    sweeps."""
    x = 0.5 * torch.arange(n, dtype=torch.float32, device=dev)
    boxes = torch.zeros((1, n, 6), device=dev)
    boxes[0, :, 0], boxes[0, :, 3] = x, x + 1.0
    boxes[0, :, 4:6] = 1.0
    return boxes, torch.ones((1, n), dtype=torch.bool, device=dev)


def check_nms_resolve(torch, dev):
    """The resolve kernel against the sweep twin on the bench scene's NMS
    problem and on a depth-2560 chain; ``eval_step.propose`` at the bench
    shape under ``set_sync_debug_mode("error")``; ms, plain ms and bound
    of the resolve kernel and of the whole ``nms_mask`` (kernels vs the
    sweep loop on the same CUDA tensors)."""
    from nerf_rpn_tpu_torch.ops.nms import nms_mask, sort_problems
    from nerf_rpn_tpu_torch.ops.nms_graph import (
        aabb_suppression_graph,
        aabb_suppression_graph_reference,
        resolve_fixpoint,
        resolve_keep,
        resolve_keep_reference,
    )

    eval_step, grids, ori = bench_eval_step(torch)
    _, obj, dl, _ = eval_step.forward(grids)
    boxes, scores, valid, thresh = capture_nms_problem(eval_step, obj, dl, ori)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eval_step.propose(obj, dl, ori)
    except RuntimeError as e:
        fail(f"eval_step.propose synchronises with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("[nms] eval_step.propose at the bench shape ran under "
          "set_sync_debug_mode('error') without a host sync", flush=True)

    _, sboxes, svalid = sort_problems(boxes, scores, valid)
    graph = aabb_suppression_graph(sboxes, thresh)
    if not torch.equal(graph, aabb_suppression_graph_reference(sboxes, thresh)):
        fail("K3 differs from its twin on the bench scene's NMS problem")
    alive = resolve_keep(graph, svalid)
    if not torch.equal(alive, resolve_keep(graph, svalid)):
        fail("resolve kernel: two runs differ")
    if not torch.equal(alive, resolve_keep_reference(graph, svalid)):
        fail(f"resolve kernel differs from the sweep twin on the bench scene in "
             f"{(alive != resolve_keep_reference(graph, svalid)).sum().item()} boxes")
    sweeps = resolve_fixpoint(graph, svalid)[1]
    chain, cvalid = chain_problem(torch, dev, 2560)
    cgraph = aabb_suppression_graph(chain, 0.3)
    calive = resolve_keep(cgraph, cvalid)
    if not (torch.equal(calive, resolve_keep_reference(cgraph, cvalid))
            and torch.equal(calive[0].cpu(), torch.arange(2560) % 2 == 0)):
        fail("resolve kernel differs from the sweep twin on the depth-2560 chain")
    print(f"[nms] resolve kernel == sweep twin on the bench scene ({tuple(graph.shape[:2])}, "
          f"{int(svalid.sum())} valid, {int(alive.sum())} kept; the twin needed {sweeps} "
          f"sweeps) and on the depth-2560 chain ({resolve_fixpoint(cgraph, cvalid)[1]} sweeps)",
          flush=True)

    def sweep_nms():
        o, sb, sv = sort_problems(boxes, scores, valid)
        keep = torch.zeros_like(valid)
        keep.scatter_(1, o, resolve_keep_reference(aabb_suppression_graph(sb, thresh),
                                                   sv)[:, :valid.shape[1]])
        return keep

    if not torch.equal(nms_mask(boxes, scores, valid, thresh), sweep_nms()):
        fail("nms_mask differs from the sweep loop on the bench scene")
    p, np_ = svalid.shape
    ms, plain_ms = time_pair(torch, lambda: resolve_keep_reference(graph, svalid),
                             lambda: resolve_keep(graph, svalid))
    chain_ms = time_one(torch, lambda: resolve_keep(cgraph, cvalid))
    resolve = dict(P=p, Np=np_, sweeps=sweeps, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                   library_ms=None, chain_ms=chain_ms,
                   **bound(4 * triangle_words(svalid) + nbytes(svalid, alive), 0, "float32"))
    print("resolve", json.dumps(resolve), flush=True)
    ms, plain_ms = time_pair(torch, sweep_nms, lambda: nms_mask(boxes, scores, valid, thresh))
    k3_ms = time_one(torch, lambda: aabb_suppression_graph(sboxes, thresh))
    whole = dict(P=p, N=valid.shape[1], Np=np_, ms=ms, plain_ms=plain_ms, k3_ms=k3_ms,
                 **bound(nbytes(boxes, scores, valid, valid), graph_ops(p, np_), "float32"))
    print("nms_mask", json.dumps(whole), flush=True)
    return resolve


def count_syncs(torch, fn):
    """``(result of fn(), host syncs it made)``: the syncs are the warnings
    of ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in seen)


def check_obb_nms(torch):
    """OBB NMS at the bench scene: the rotated Swin-S bf16 eval step's NMS
    problem (4 x 2560 OBBs decoded from its head outputs).  The keep-set on
    the card (rotated graph in torch, resolve kernel) must equal the one on
    CPU copies; the resolve kernel must equal its sweep twin on the card's
    graph.  Prints ``nms_mask``'s device ms (host syncs included), its
    graph build's and the resolve kernel's, the gated pairs, the host syncs
    of ``nms_mask`` and of the whole propose step, and the launches."""
    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.ops.nms import nms_mask, obb_suppression_graph, sort_problems
    from nerf_rpn_tpu_torch.ops.nms_graph import resolve_keep, resolve_keep_reference

    eval_step, grids, ori = bench_eval_step(torch, rotated=True)
    _, obj, dl, _ = eval_step.forward(grids)
    boxes, scores, valid, thresh = capture_nms_problem(eval_step, obj, dl, ori)
    if boxes.shape[-1] != 7:
        fail(f"the rotated eval step's NMS problem is {tuple(boxes.shape)}, not OBBs")
    kernels.reset_counts()
    keep, nms_syncs = count_syncs(torch, lambda: nms_mask(boxes, scores, valid, thresh))
    launches = {k: v for k, v in kernels.counts().items() if v}
    if launches != {"nms_resolve": 1}:
        fail(f"OBB nms_mask launched {launches}, expected the resolve kernel once")
    cpu_keep = nms_mask(boxes.cpu(), scores.cpu(), valid.cpu(), thresh)
    if not torch.equal(keep.cpu(), cpu_keep):
        fail(f"OBB nms_mask on the card differs from the CPU in "
             f"{(keep.cpu() != cpu_keep).sum().item()} boxes")
    _, sboxes, svalid = sort_problems(boxes, scores, valid)
    stats = {}
    graph = obb_suppression_graph(sboxes, thresh, stats=stats)
    alive = resolve_keep(graph, svalid)
    if not torch.equal(alive, resolve_keep_reference(graph, svalid)):
        fail("resolve kernel differs from the sweep twin on the OBB graph")
    _, propose_syncs = count_syncs(torch, lambda: eval_step.propose(obj, dl, ori))
    p, np_ = svalid.shape
    row = dict(P=p, N=boxes.shape[1], Np=np_, valid=int(valid.sum()), kept=int(keep.sum()),
               pairs=stats["pairs"], gated=stats["gated"],
               gate_pass_rate=stats["gated"] / stats["pairs"],
               syncs_nms_mask=nms_syncs, syncs_by_chunk=stats["syncs"],
               syncs_propose=propose_syncs, launches=launches,
               ms=time_one(torch, lambda: nms_mask(boxes, scores, valid, thresh)),
               graph_ms=time_one(torch, lambda: obb_suppression_graph(sboxes, thresh)),
               resolve_ms=time_one(torch, lambda: resolve_keep(graph, svalid)))
    print("nms_mask_obb", json.dumps(row), flush=True)
    return row


# ``scripts/test_fcos.sh``'s head flags and ``scripts/train_fcos.sh``'s loss
# and optimizer flags (its batch 8 over 4 GPUs is 2 a card)
FCOS_FLAGS = ["--norm_reg_targets", "--centerness_on_reg", "--nms_thresh", "0.3"]
FCOS_TRAIN_FLAGS = [*FCOS_FLAGS, "--center_sampling_radius", "1.5", "--iou_loss_type", "iou",
                    "--normalize_density", "--lr", "3e-4", "--weight_decay", "1e-3"]
# FCOS's NMS problem at 160^3: the top 2500 of 64000, 2500 of 8000, all
# 1000 and all 125 locations of the four levels, padded to a multiple of 256
FCOS_NMS_N, FCOS_NMS_NP = 6125, 6144


def fcos_bench_eval_step(torch, rotated):
    """The eval step of ``run_fcos --mode benchmark`` (Swin-S, bf16, 160^3,
    random weights from seed 0; OBBs with ``rotated``), its model, its
    random grid and the scene's size: ``(eval_step, model, grids, ori)``."""
    import numpy as np

    from nerf_rpn_tpu_torch.cli import run_fcos

    args = run_fcos.parse_args(["--mode", "benchmark", "--backbone_type", "swin_s", "--bf16",
                                *FCOS_FLAGS, *(["--rotated_bbox"] if rotated else [])])
    trainer = run_fcos.Trainer(args)
    shape = run_fcos.BENCH_SHAPE
    eval_step = trainer.eval_step(shape)
    rng = np.random.default_rng(args.seed)
    grids = torch.from_numpy(rng.standard_normal((1, *shape, 4), np.float32)).to(
        trainer.device, trainer.dtype)
    ori = torch.tensor([shape], dtype=torch.int32, device=trainer.device)
    return eval_step, trainer.model, grids, ori


def device_busy(torch, fn):
    """``(device-busy ms, kernels)`` of one call of ``fn``: the union of
    the device spans that ``torch.profiler`` records."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3, len(spans)


def check_fcos_nms(torch):
    """FCOS's NMS problem at its bench scene, as AABBs and as OBBs: one
    problem of 6125 boxes padded to Np = 6144.  The keep-set on the card
    must equal the CPU's, K3 (AABB) and the resolve kernel their twins;
    prints their ms, ``nms_mask``'s, the OBB graph's gated pairs, the host
    syncs of ``nms_mask`` and of the whole propose, and the device-busy ms
    of one ``nms_mask`` call.

    With random weights half of the head's distances are 0 after its ReLU,
    so nearly every box of the bench scene has no volume and NMS keeps
    them all.  Each form is therefore also checked on the same scene with
    1 added to the distance channels' bias ("overlapping"): boxes with
    volume that overlap their neighbours, where NMS suppresses."""
    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.models import fcos as fcos_lib
    from nerf_rpn_tpu_torch.ops.nms import nms_mask, obb_suppression_graph, sort_problems
    from nerf_rpn_tpu_torch.ops.nms_graph import (
        aabb_suppression_graph,
        aabb_suppression_graph_reference,
        resolve_fixpoint,
        resolve_keep,
        resolve_keep_reference,
    )

    rows = {}
    for rotated, overlapping in ((False, False), (False, True), (True, False), (True, True)):
        kind = ("obb" if rotated else "aabb") + ("_overlapping" if overlapping else "")
        if overlapping:  # the step reads the model's parameters: bump them in place
            with torch.no_grad():
                model.fcos_head.bbox_pred.bias[:6] += 1.0
        else:
            eval_step, model, grids, ori = fcos_bench_eval_step(torch, rotated)
        cls_f, reg_f, ctr_f, _ = eval_step.forward(grids)
        heads = (cls_f, reg_f, ctr_f, ori)
        boxes, scores, valid, thresh = capture_nms_problem(eval_step, *heads, module=fcos_lib)
        if tuple(boxes.shape) != (1, FCOS_NMS_N, 7 if rotated else 6):
            fail(f"FCOS {kind} NMS problem is {tuple(boxes.shape)}, expected "
                 f"(1, {FCOS_NMS_N}, .)")
        kernels.reset_counts()
        keep, nms_syncs = count_syncs(torch, lambda: nms_mask(boxes, scores, valid, thresh))
        launches = {k: v for k, v in kernels.counts().items() if v}
        want = {"nms_resolve": 1, **({} if rotated else {"aabb_suppression_graph": 1})}
        if launches != want:
            fail(f"FCOS {kind} nms_mask launched {launches}, expected {want}")
        cpu_keep = nms_mask(boxes.cpu(), scores.cpu(), valid.cpu(), thresh)
        if not torch.equal(keep.cpu(), cpu_keep):
            fail(f"FCOS {kind} nms_mask on the card differs from the CPU in "
                 f"{(keep.cpu() != cpu_keep).sum().item()} boxes")
        _, sboxes, svalid = sort_problems(boxes, scores, valid)
        p, np_ = svalid.shape
        if np_ != FCOS_NMS_NP:
            fail(f"FCOS {kind} NMS pads to Np = {np_}, expected {FCOS_NMS_NP}")
        row = dict(P=p, N=boxes.shape[1], Np=np_, valid=int(valid.sum()), kept=int(keep.sum()),
                   syncs_nms_mask=nms_syncs, launches=launches)
        if rotated:
            stats = {}
            graph = obb_suppression_graph(sboxes, thresh, stats=stats)
            row.update(pairs=stats["pairs"], gated=stats["gated"],
                       gate_pass_rate=stats["gated"] / stats["pairs"],
                       syncs_by_chunk=stats["syncs"],
                       graph_ms=time_one(torch, lambda: obb_suppression_graph(sboxes, thresh)))
        else:
            graph = aabb_suppression_graph(sboxes, thresh)
            if not torch.equal(graph, aabb_suppression_graph_reference(sboxes, thresh)):
                fail("K3 differs from its twin at the FCOS problem (Np = 6144)")
            k3_ms, k3_plain = time_pair(
                torch, lambda: aabb_suppression_graph_reference(sboxes, thresh),
                lambda: aabb_suppression_graph(sboxes, thresh))
            row.update(k3_ms=k3_ms, k3_plain_ms=k3_plain,
                       k3_bound=bound(nbytes(sboxes) + 4 * p * np_ * np_ // 32,
                                      graph_ops(p, np_), "float32"))
        alive = resolve_keep(graph, svalid)
        if not torch.equal(alive, resolve_keep_reference(graph, svalid)):
            fail(f"resolve kernel differs from the sweep twin at the FCOS {kind} problem")
        resolve_ms, resolve_plain = time_pair(torch, lambda: resolve_keep_reference(graph, svalid),
                                              lambda: resolve_keep(graph, svalid))
        _, propose_syncs = count_syncs(torch, lambda: eval_step.propose(*heads))
        busy_ms, busy_kernels = device_busy(torch, lambda: nms_mask(boxes, scores, valid, thresh))
        row.update(sweeps=resolve_fixpoint(graph, svalid)[1], resolve_ms=resolve_ms,
                   resolve_plain_ms=resolve_plain,
                   resolve_bound=bound(4 * triangle_words(svalid) + nbytes(svalid, alive), 0,
                                       "float32"),
                   syncs_propose=propose_syncs,
                   nms_mask_ms=time_one(torch, lambda: nms_mask(boxes, scores, valid, thresh)),
                   nms_mask_busy_ms=busy_ms, nms_mask_kernels=busy_kernels)
        if not rotated and propose_syncs:
            fail(f"FCOS AABB propose synchronised {propose_syncs} times with the host")
        if overlapping and not 0 < row["kept"] < row["valid"]:
            fail(f"FCOS {kind}: NMS kept {row['kept']} of {row['valid']}: it should suppress")
        print(f"fcos_nms_{kind}", json.dumps(row), flush=True)
        rows[kind] = row
    return rows


def check_fused_window_attention(torch, dev):
    """K4 against its twin at the four eval stages of the RPN and of the
    FCOS bench and the RCNN fine-tune eval's (batch 2: the ids tiled over
    the scenes), the mask table and ids from the real shift mask, q/k/v as
    strided views of a packed qkv (as the eval route passes them)."""
    import torch.nn.functional as F

    from nerf_rpn_tpu_torch.models.swin import shift_mask_patterns
    from nerf_rpn_tpu_torch.ops.window_attention import (
        fused_window_attention,
        fused_window_attention_reference,
        head_group,
        tile_bytes,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(11)
    rows, main = [], None
    for name, size, heads, c, b in EVAL_STAGES + FCOS_EVAL_STAGES + RCNN_EVAL_STAGES:
        pad = tuple(-(-s // 4) * 4 for s in size)
        table_np, ids_np = shift_mask_patterns(pad, (4, 4, 4), (2, 2, 2))
        table = torch.from_numpy(table_np).to(dev)
        ids = torch.from_numpy(ids_np).to(dev).repeat(b)
        w, d = len(ids), c // heads
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn((w, 64, 3 * c), generator=gen, device=dev).to(dtype)
            bias = 0.5 * torch.randn((heads, 64, 64), generator=gen, device=dev)
            q, k, v = sdpa_views(qkv, heads)
            out = fused_window_attention(q, k, v, bias, table, ids)
            ref = fused_window_attention_reference(q, k, v, bias, table, ids)
            err, ok = close_enough(torch, out, ref, dtype)
            if not ok:
                fail(f"K4 {name} {dtype}: max|err| {err} outside the tolerance")
            ms, plain_ms = time_pair(
                torch, lambda: fused_window_attention_reference(q, k, v, bias, table, ids),
                lambda: fused_window_attention(q, k, v, bias, table, ids))
            am = (bias[None] + table[ids.long()][:, None]).to(dtype)
            library_ms = time_one(
                torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am))
            group = head_group(w, heads, d, dtype)
            row = dict(stage=name, B=b, W=w, H=heads, C=c, P=len(table_np),
                       dtype=dtype_name(dtype),
                       G=group, smem_bytes=group * tile_bytes(d, dtype),
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       **bound(nbytes(q, k, v, bias, table, ids, out),
                               4 * w * heads * 64 * 64 * d, dtype_name(dtype)))
            rows.append(row)
            print("K4", json.dumps(row), flush=True)
            if name == "stage0" and dtype == torch.bfloat16:
                main = row
    return rows, main


def check_ln_partition_qkv(torch, dev):
    """K5 against its twin at the four eval stages of the RPN and of the
    FCOS bench and the RCNN fine-tune eval's (batch 2 and 1) (the pad
    inside, shift 2 as on every odd block), the qkv weight as
    ``Linear.weight.t()``."""
    from nerf_rpn_tpu_torch.ops.fused_ln_qkv import (
        ln_partition_qkv,
        ln_partition_qkv_reference,
        ln_qkv_plan,
        plan_blocks,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(12)
    rows, main = [], None
    for name, size, _, c, batch in (EVAL_STAGES + FCOS_EVAL_STAGES + RCNN_EVAL_STAGES
                                    + RCNN_SCENE_STAGES):
        pad = tuple(-(-s // 4) * 4 for s in size)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((batch, *size, c), generator=gen, device=dev).to(dtype)
            s = 1 + 0.2 * torch.randn(c, generator=gen, device=dev)
            t = 0.2 * torch.randn(c, generator=gen, device=dev)
            wq = (torch.randn((3 * c, c), generator=gen, device=dev) * c ** -0.5).to(dtype).t()
            b = 0.5 * torch.randn(3 * c, generator=gen, device=dev)
            args = (x, s, t, wq, b, (4, 4, 4), pad, (2, 2, 2))
            out = ln_partition_qkv(*args)
            ref = ln_partition_qkv_reference(*args)
            err, ok = close_enough(torch, out, ref, dtype)
            if not ok:
                fail(f"K5 {name} {dtype}: max|err| {err} outside the tolerance")
            ms, plain_ms = time_pair(torch, lambda: ln_partition_qkv_reference(*args),
                                     lambda: ln_partition_qkv(*args))
            tokens = batch * math.prod(size)
            plan = ln_qkv_plan(out.shape[0], c, dtype)
            row = dict(stage=name, B=batch, grid=list(size), pad=list(pad), C=c,
                       dtype=dtype_name(dtype),
                       plan=dict(zip(("R", "BN", "BK", "G"), plan)),
                       blocks=plan_blocks(out.shape[0], 64, c, plan),
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                       **bound(nbytes(x, s, t, wq, b, out), 2 * tokens * c * 3 * c,
                               dtype_name(dtype)))
            rows.append(row)
            print("K5", json.dumps(row), flush=True)
            if name == "stage0" and dtype == torch.bfloat16:
                main = row
    return rows, main


def check_fused_mlp(torch, dev):
    """K6 against its twin on the tokens of the four eval stages of the RPN
    and of the FCOS bench and the RCNN fine-tune eval's (batch 2 and 1),
    the weights as the model passes them (``Linear.weight.t()``)."""
    from nerf_rpn_tpu_torch.ops.fused_mlp import (
        fused_mlp_block,
        fused_mlp_block_reference,
        mlp_plan,
        plan_blocks,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(13)
    rows, main = [], None
    for name, size, _, c, batch in (EVAL_STAGES + FCOS_EVAL_STAGES + RCNN_EVAL_STAGES
                                    + RCNN_SCENE_STAGES):
        tokens, hd = batch * math.prod(size), 4 * c
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((tokens, c), generator=gen, device=dev).to(dtype)
            args = (x, 1 + 0.2 * torch.randn(c, generator=gen, device=dev),
                    0.2 * torch.randn(c, generator=gen, device=dev),
                    (torch.randn((hd, c), generator=gen, device=dev) * c ** -0.5).to(dtype).t(),
                    (0.3 * torch.randn(hd, generator=gen, device=dev)).to(dtype),
                    (torch.randn((c, hd), generator=gen, device=dev) * hd ** -0.5).to(dtype).t(),
                    (0.3 * torch.randn(c, generator=gen, device=dev)).to(dtype))
            out = fused_mlp_block(*args)
            ref = fused_mlp_block_reference(*args)
            err, ok = close_enough(torch, out, ref, dtype)
            if not ok:
                fail(f"K6 {name} {dtype}: max|err| {err} outside the tolerance")
            ms, plain_ms = time_pair(torch, lambda: fused_mlp_block_reference(*args),
                                     lambda: fused_mlp_block(*args))
            plan = mlp_plan(tokens, c, hd, dtype)
            row = dict(stage=name, T=tokens, C=c, dtype=dtype_name(dtype),
                       plan=dict(zip(("R", "S", "BN", "BK"), plan)),
                       blocks=plan_blocks(tokens, plan), max_abs_err=err,
                       ms=ms, plain_ms=plain_ms, library_ms=None,
                       **bound(nbytes(*args, out), 4 * tokens * c * hd, dtype_name(dtype)))
            rows.append(row)
            print("K6", json.dumps(row), flush=True)
            if name == "stage0" and dtype == torch.bfloat16:
                main = row
    return rows, main


def check_small_slice(torch, dev):
    """swin_t at 64^3, f32, same weights: GPU (kernels) vs CPU (twins)."""
    import numpy as np

    from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN, init_params
    from nerf_rpn_tpu_torch.models.rpn import RPNConfig
    from nerf_rpn_tpu_torch.train.steps import make_rpn_eval_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (64, 64, 64)
    cfg = RPNConfig(pre_nms_top_n=600, post_nms_top_n=300)
    cpu = NeRFRPN("swin_t", conv_depth=2)
    init_params(cpu, torch.Generator().manual_seed(0))
    with torch.no_grad():  # moderate head outputs: no saturated score ties
        cpu.rpn_head.cls_logits.weight.mul_(0.05)
        cpu.rpn_head.bbox_pred.weight.mul_(0.05)
    gpu = NeRFRPN("swin_t", conv_depth=2)
    gpu.load_state_dict(cpu.state_dict())
    cpu_step = make_rpn_eval_step(cpu.eval(), cfg, shape)
    gpu_step = make_rpn_eval_step(gpu.to(dev).eval(), cfg, shape, device=dev)
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (1, *shape, 4)).astype(np.float32))
    ori = torch.tensor([[60, 56, 64]], dtype=torch.int32)
    _, c_obj, c_dl, _ = cpu_step.forward(x)
    _, g_obj, g_dl, _ = gpu_step.forward(x.to(dev))
    worst = 0.0
    for c, g in zip(c_obj + c_dl, g_obj + g_dl):
        # f32 through ~20 layers, cuDNN/cuBLAS vs CPU sum orders: 1e-4
        err = (g.cpu() - c).abs().max().item()
        worst = max(worst, err)
        if not err <= 1e-4 * (1.0 + c.abs().max().item()):
            fail(f"small slice head outputs differ by {err}")
    c_out = cpu_step.propose(c_obj, c_dl, ori)
    g_out = gpu_step.propose([t.to(dev) for t in c_obj], [t.to(dev) for t in c_dl], ori.to(dev))
    for k in ("valid", "level_idx"):
        if not torch.equal(g_out[k].cpu(), c_out[k]):
            fail(f"small slice proposals: {k} differs from the CPU run")
    box_err = (g_out["boxes"].cpu() - c_out["boxes"]).abs().max().item()
    if not box_err <= 1e-6 * shape[0]:
        fail(f"small slice proposal boxes differ by {box_err}")
    print(f"[small slice] head max|err| {worst:.3g}, proposals: keep-set equal, "
          f"boxes max|err| {box_err:.3g}, {int(c_out['valid'].sum())} valid", flush=True)


def run_eval_path(torch, workdir):
    import numpy as np

    from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_dataset
    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.cli import run_rpn

    data = os.path.join(workdir, "data")
    out_dir = os.path.join(workdir, "out")
    write_synthetic_dataset(data, n_train=0, n_val=0, n_test=3,
                            resolution=(200, 200, 130), seed=0)
    common = ["--backbone_type", "swin_s", "--bf16", "--resolution", "200",
              "--pad_multiple", "16", "--device", "cuda"]
    kernels.reset_counts()
    recalls, aps = run_rpn.main([
        "--mode", "eval", *common, "--features_path", data, "--boxes_path", data,
        "--dataset_split", os.path.join(data, "split.npz"), "--save_path", out_dir,
        "--output_proposals"])
    torch.cuda.synchronize()
    eval_launches = kernels.counts()
    kernels.reset_counts()
    bench = run_rpn.main(["--mode", "benchmark", *common])
    torch.cuda.synchronize()
    bench_launches = kernels.counts()
    launches = {k: eval_launches[k] + bench_launches[k] for k in eval_launches}

    if not os.path.exists(os.path.join(out_dir, "eval.json")):
        fail("eval.json was not written")
    with open(os.path.join(out_dir, "eval.json")) as f:
        report = json.load(f)
    metrics = [recalls[0], aps[0], report["recall_25_top_300"]["ar"], report["ap_25"]["ap"]]
    if not all(np.isfinite(metrics)):
        fail(f"non-finite metrics {metrics}")
    files = sorted(os.listdir(os.path.join(out_dir, "proposals")))
    if len(files) != 3:
        fail(f"expected 3 proposal files, got {files}")
    for name in files:
        with np.load(os.path.join(out_dir, "proposals", name)) as z:
            p, s = z["proposal"], z["score"]
        if p.ndim != 2 or p.shape[1] != 6 or p.shape[0] != s.shape[0] or p.shape[0] == 0:
            fail(f"{name}: proposals {p.shape}, scores {s.shape}")
        if not (np.isfinite(p).all() and np.isfinite(s).all()):
            fail(f"{name}: non-finite proposals")
        if not ((s >= 0) & (s <= 1)).all() or not (p[:, 3:] >= p[:, :3]).all():
            fail(f"{name}: scores outside [0, 1] or inverted boxes")
        if p.min() < 0 or (p[:, 3:] > 208).any():
            fail(f"{name}: boxes leave the padded grid")
    times = [bench[k] for k in ("forward_ms", "propose_ms", "total_ms")]
    if not all(np.isfinite(times)) or bench["valid_proposals"] <= 0:
        fail(f"benchmark {bench}")
    print(f"[eval path] eval: recall@50 {recalls[0]:.4f}, AP@50 {aps[0]:.4f}, "
          f"recall@25 {report['recall_25_top_300']['ar']:.4f}, "
          f"AP@25 {report['ap_25']['ap']:.4f} on 3 random-weight scenes", flush=True)
    print(f"[eval path] benchmark {bench['shape']} bf16, {bench['reps']} reps: "
          f"forward {bench['forward_ms']:.3f} ms/scene, propose "
          f"{bench['propose_ms']:.3f} ms/scene, whole {bench['total_ms']:.3f} "
          f"ms/scene (median {bench['total_median_ms']:.3f}, "
          f"p{bench['tail_percentile']:.1f} {bench['total_tail_ms']:.3f})", flush=True)
    require_launches(launches, EVAL_KERNELS, "eval")
    # every benchmark scene runs the same kernels: per scene, Swin-S's 24
    # blocks each run K5 and K6, its 12 shifted blocks K4 (every stage grid
    # of the bench shape is wider than a window) and the 12 others K1; K3
    # and the resolve kernel run once in propose
    scenes = bench["reps"] + bench["warmup"]
    per_scene = {k: v / scenes for k, v in bench_launches.items() if v}
    if per_scene != EVAL_LAUNCHES_PER_SCENE:
        fail(f"eval path: launches per scene {per_scene}, expected {EVAL_LAUNCHES_PER_SCENE}")
    print(f"[eval path] launches per benchmark scene {json.dumps(per_scene)}", flush=True)
    return launches, bench


def run_obb_benchmark(torch):
    """``run_rpn --mode benchmark --rotated_bbox`` (Swin-S, bf16,
    208x208x144): ms a scene, and the launches a scene -- the eval kernels
    as on the AABB path, the resolve kernel once, K3 never."""
    import numpy as np

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.cli import run_rpn

    kernels.reset_counts()
    bench = run_rpn.main(["--mode", "benchmark", "--rotated_bbox", "--backbone_type", "swin_s",
                          "--bf16", "--resolution", "200", "--pad_multiple", "16",
                          "--device", "cuda"])
    torch.cuda.synchronize()
    launches = kernels.counts()
    times = [bench[k] for k in ("forward_ms", "propose_ms", "total_ms")]
    if not all(np.isfinite(times)) or bench["valid_proposals"] <= 0:
        fail(f"OBB benchmark {bench}")
    print(f"[obb eval path] benchmark {bench['shape']} bf16, {bench['reps']} reps: "
          f"forward {bench['forward_ms']:.3f} ms/scene, propose "
          f"{bench['propose_ms']:.3f} ms/scene, whole {bench['total_ms']:.3f} "
          f"ms/scene (median {bench['total_median_ms']:.3f}, "
          f"p{bench['tail_percentile']:.1f} {bench['total_tail_ms']:.3f})", flush=True)
    scenes = bench["reps"] + bench["warmup"]
    per_scene = {k: v / scenes for k, v in launches.items() if v}
    if per_scene != OBB_EVAL_LAUNCHES_PER_SCENE:
        fail(f"OBB eval path: launches per scene {per_scene}, expected "
             f"{OBB_EVAL_LAUNCHES_PER_SCENE}")
    print(f"[obb eval path] launches per benchmark scene {json.dumps(per_scene)}", flush=True)
    return launches, bench


def run_fcos_benchmark(torch, rotated):
    """``run_fcos --mode benchmark`` (Swin-S, bf16, 160^3, ``test_fcos.sh``'s
    head flags; OBBs with ``rotated``): ms a scene and the launches a scene
    -- the eval kernels as on the RPN path, the resolve kernel once, K3
    once for AABBs and never for OBBs."""
    import numpy as np

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.cli import run_fcos

    path = f"fcos {'obb' if rotated else 'aabb'} eval"
    kernels.reset_counts()
    bench = run_fcos.main(["--mode", "benchmark", "--backbone_type", "swin_s", "--bf16",
                           *FCOS_FLAGS, *(["--rotated_bbox"] if rotated else []),
                           "--device", "cuda"])
    torch.cuda.synchronize()
    launches = kernels.counts()
    times = [bench[k] for k in ("forward_ms", "propose_ms", "total_ms")]
    if not all(np.isfinite(times)) or bench["valid_proposals"] <= 0:
        fail(f"{path} benchmark {bench}")
    print(f"[{path} path] benchmark {bench['shape']} bf16, {bench['reps']} reps: "
          f"forward {bench['forward_ms']:.3f} ms/scene, propose "
          f"{bench['propose_ms']:.3f} ms/scene, whole {bench['total_ms']:.3f} "
          f"ms/scene (median {bench['total_median_ms']:.3f}, "
          f"p{bench['tail_percentile']:.1f} {bench['total_tail_ms']:.3f})", flush=True)
    require_launches(launches, OBB_EVAL_KERNELS if rotated else EVAL_KERNELS, path,
                     absent=("aabb_suppression_graph",) if rotated else ())
    scenes = bench["reps"] + bench["warmup"]
    per_scene = {k: v / scenes for k, v in launches.items() if v}
    want = OBB_EVAL_LAUNCHES_PER_SCENE if rotated else EVAL_LAUNCHES_PER_SCENE
    if per_scene != want:
        fail(f"{path}: launches per scene {per_scene}, expected {want}")
    print(f"[{path} path] launches per benchmark scene {json.dumps(per_scene)}", flush=True)
    return launches, bench


def check_small_train_step(torch, dev):
    """swin_t at 64^3, f32, batch 2, drop-path off: one train step on the
    GPU (K1 forward, K2 backward) against the same step on the CPU (plain
    twins), with the same weights and the same anchor sample injected."""
    import numpy as np

    from nerf_rpn_tpu_torch.models import rpn as rpn_lib
    from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN, init_params
    from nerf_rpn_tpu_torch.models.swin import SwinBlock
    from nerf_rpn_tpu_torch.train.state import TrainState
    from nerf_rpn_tpu_torch.train.steps import level_shapes_for, make_rpn_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shape, strides = (64, 64, 64), (4, 8, 16, 32)
    cfg = rpn_lib.RPNConfig(reg_loss_weight=5.0, reg_loss_weight_2d=0.5)
    rng = np.random.default_rng(4)
    gt = np.zeros((2, 8, 6), np.float32)
    gt[0, :3] = [[4, 6, 8, 28, 24, 36], [32, 32, 16, 56, 60, 40], [8, 40, 40, 24, 60, 62]]
    gt[1, :2] = [[0, 0, 0, 40, 32, 24], [20, 24, 28, 36, 40, 48]]
    batch = {"grids": torch.from_numpy(rng.uniform(0, 1, (2, *shape, 4)).astype(np.float32)),
             "gt_boxes": torch.from_numpy(gt), "gt_mask": torch.from_numpy(gt[..., 3] > 0),
             "ori_sizes": torch.tensor([[64, 60, 64], [56, 64, 52]], dtype=torch.int32)}
    # the anchor sample, drawn once on the CPU and fed to both steps
    shapes = level_shapes_for(shape, strides)
    anchors, _, level_strides, _ = rpn_lib.build_level_tables(cfg, shape, shapes)
    pad = rpn_lib.dynamic_padding_masks(shapes, level_strides, 13, batch["ori_sizes"])
    matches = rpn_lib.assign_anchors(cfg, torch.from_numpy(anchors), batch["gt_boxes"],
                                     batch["gt_mask"], pad)
    indices = rpn_lib.sample_anchors(cfg, matches, torch.Generator().manual_seed(0))

    cpu = NeRFRPN("swin_t", conv_depth=2)
    init_params(cpu, torch.Generator().manual_seed(0))
    with torch.no_grad():  # moderate head outputs, as in the small slice
        cpu.rpn_head.cls_logits.weight.mul_(0.05)
        cpu.rpn_head.bbox_pred.weight.mul_(0.05)
    gpu = NeRFRPN("swin_t", conv_depth=2)
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    results = []
    for model, d in ((cpu, torch.device("cpu")), (gpu, dev)):
        for m in model.modules():
            if isinstance(m, SwinBlock):
                m.drop_path = 0.0
        state = TrainState(model, 1e-3, 10)
        grads = {}
        apply = state.apply_gradients

        def capture(model=model, grads=grads, apply=apply):
            grads.update({n: p.grad.detach().cpu().clone()
                          for n, p in model.named_parameters()})
            return apply()

        state.apply_gradients = capture
        step = make_rpn_train_step(model, cfg, shape, strides, device=d)
        metrics = step(state, {k: v.to(d) for k, v in batch.items()},
                       torch.Generator(d).manual_seed(0), torch.Generator(d).manual_seed(1),
                       indices=[t.to(d) for t in indices])
        results.append(({k: float(v) for k, v in metrics.items()}, grads))
    (c_m, c_g), (g_m, g_g) = results
    for k in ("loss", "loss_objectness", "loss_rpn_box_reg", "loss_rpn_box_reg_2d", "grad_norm"):
        # f32 through ~20 layers and their backward, other sum orders: 1e-4
        if not (np.isfinite(g_m[k]) and abs(g_m[k] - c_m[k]) <= 1e-4 * abs(c_m[k])):
            fail(f"small train step: {k} GPU {g_m[k]} vs CPU {c_m[k]}")
    worst = 0.0
    for name, c in c_g.items():
        scale = c.abs().max().item()
        err = (g_g[name] - c).abs().max().item()
        if scale == 0:
            if err != 0:
                fail(f"small train step: gradient {name} should be 0, max|g| {err}")
            continue
        worst = max(worst, err / scale)
        # 1e-3 of each leaf's largest entry, as the CPU test against JAX
        if not err <= 1e-3 * scale:
            fail(f"small train step: gradient {name} max|err| {err} vs scale {scale}")
    print(f"[small train step] loss GPU {g_m['loss']:.6f} vs CPU {c_m['loss']:.6f}; "
          f"worst gradient leaf max|err| / max|g| {worst:.3g} over {len(c_g)} leaves",
          flush=True)


EVAL_KERNELS = ("window_attention_fwd", "aabb_suppression_graph", "nms_resolve",
                "fused_window_attention", "ln_partition_qkv", "fused_mlp_block")
# the train steps run K1 forward and K2 backward; the validation eval runs
# the eval kernels
TRAIN_KERNELS = ("window_attention_bwd", *EVAL_KERNELS)
EVAL_LAUNCHES_PER_SCENE = {"ln_partition_qkv": 24.0, "fused_mlp_block": 24.0,
                           "fused_window_attention": 12.0, "window_attention_fwd": 12.0,
                           "aabb_suppression_graph": 1.0, "nms_resolve": 1.0}
# OBBs: the same eval kernels, the rotated graph in torch, so no K3
OBB_EVAL_KERNELS = tuple(k for k in EVAL_KERNELS if k != "aabb_suppression_graph")
OBB_TRAIN_KERNELS = ("window_attention_bwd", *OBB_EVAL_KERNELS)
OBB_EVAL_LAUNCHES_PER_SCENE = {k: v for k, v in EVAL_LAUNCHES_PER_SCENE.items()
                               if k != "aabb_suppression_graph"}


def require_launches(launches, names, path, absent=()):
    for name in names:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the {path} path")
    for name in absent:
        if launches[name] != 0:
            fail(f"kernel {name} was launched {launches[name]} times on the {path} path")
    print(f"[{path} path] launches {json.dumps(launches)}", flush=True)


def write_train_data(workdir, resolution=160, backbone="swin_s", device="cuda",
                     rotated=False):
    """4 train, 2 validation and 2 test synthetic scenes at ``resolution``^3
    under ``workdir`` (OBBs with ``rotated``; written once, as the seed
    gives the same scenes each time), and the ``run_rpn`` arguments of the
    train path (bf16, batch 2; ``--rotated_bbox`` with ``rotated``) that
    read them: ``(data dir, arguments)``."""
    from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_dataset

    data = os.path.join(workdir, f"data{resolution}" + ("_obb" if rotated else ""))
    if not os.path.isfile(os.path.join(data, "split.npz")):
        write_synthetic_dataset(data, n_train=4, n_val=2, n_test=2,
                                resolution=(resolution,) * 3, seed=1, rotated=rotated,
                                box_size=(resolution / 10, resolution / 4))
    common = ["--backbone_type", backbone, "--bf16", "--resolution", str(resolution),
              "--batch_size", "2", "--device", device, "--features_path", data,
              "--boxes_path", data, "--dataset_split", os.path.join(data, "split.npz"),
              *(["--rotated_bbox"] if rotated else [])]
    return data, common


def run_train_path(torch, workdir, resolution=160, backbone="swin_s", device="cuda",
                   rotated=False, fcos=False, extra=()):
    """``run_rpn --mode train`` on synthetic 160^3 scenes (Swin-S, bf16,
    batch 2; OBBs and ``--rotated_bbox`` with ``rotated``, the
    ``scripts/train.sh`` configuration), then ``--mode eval --checkpoint
    <save>/model_best``; with ``fcos`` the same through ``run_fcos`` with
    ``scripts/train_fcos.sh``'s flags, no positive dropped by the loss, and
    the eval with ``--save_level_index``.  ``extra`` flags go to both runs
    (and name the path and its save directory).  The other keywords shrink
    the run for a rehearsal on the CPU."""
    import numpy as np

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.cli import run_fcos, run_rpn
    from nerf_rpn_tpu_torch.models.swin import SWIN_VARIANTS

    path = " ".join(["fcos"] * fcos + ["obb train" if rotated else "train", *extra])
    cli = run_fcos if fcos else run_rpn
    data, common = write_train_data(workdir, resolution, backbone, device, rotated)
    if fcos:
        common = [*common, *FCOS_TRAIN_FLAGS]
        keys = ("loss", "loss_cls", "loss_reg", "loss_centerness", "grad_norm", "param_norm")
    else:
        keys = ("loss", "loss_objectness", "loss_rpn_box_reg", "grad_norm", "param_norm")
    save = os.path.join(workdir, path.replace(" ", "_").replace("-", ""))
    t0 = time.perf_counter()
    kernels.reset_counts()
    logged = cli.main(["--mode", "train", "--num_epochs", "1", "--log_interval", "1",
                       "--save_path", save, *common, *extra])
    torch.cuda.synchronize()
    launches = kernels.counts()
    train_s = time.perf_counter() - t0
    if len(logged) != 2:
        fail(f"{path} path: expected 2 logged steps, got {len(logged)}")
    for m in logged:
        if not (np.all(np.isfinite([m[k] for k in keys])) and m["loss"] > 0):
            fail(f"{path} path: bad metrics {m}")
        if fcos and m["dropped_positives"] != 0:
            fail(f"{path} path: the loss dropped {m['dropped_positives']} positives")
    for name in ("model_best", "epoch_1", "model_best.args.json"):
        if not os.path.isfile(os.path.join(save, name)):
            fail(f"{path} path: {name} was not written")
    print(f"[{path} path] 1 epoch, 2 steps + validation eval in {train_s:.1f} s; losses "
          + ", ".join(f"{m['loss']:.4f}" for m in logged), flush=True)
    k3 = ("aabb_suppression_graph",)
    require_launches(launches, OBB_TRAIN_KERNELS if rotated else TRAIN_KERNELS, path,
                     absent=k3 if rotated else ())
    # the backward runs once per Swin block and train step
    want = len(logged) * sum(SWIN_VARIANTS[backbone]["depths"])
    if launches["window_attention_bwd"] != want:
        fail(f"{path} path: window_attention_bwd launched {launches['window_attention_bwd']} "
             f"times over {len(logged)} steps, expected {want}")

    kernels.reset_counts()
    out = save + "_eval_ckpt"
    recalls, _ = cli.main(["--mode", "eval", "--checkpoint", os.path.join(save, "model_best"),
                           "--save_path", out, "--output_proposals",
                           *(["--save_level_index"] if fcos else []), *common, *extra])
    torch.cuda.synchronize()
    eval_launches = kernels.counts()
    files = sorted(os.listdir(os.path.join(out, "proposals")))
    if len(files) != 2 or not np.all(np.isfinite(recalls)):
        fail(f"{path} eval from the checkpoint: files {files}, recalls {recalls}")
    for name in files:
        with np.load(os.path.join(out, "proposals", name)) as z:
            p, s = z["proposal"], z["score"]
            levels = z["level_indices"] if fcos else np.zeros(len(p))
        if (p.shape[0] == 0 or p.shape[1] != (7 if rotated else 6) or len(levels) != len(p)
                or not (np.isfinite(p).all() and np.isfinite(s).all())):
            fail(f"{path} eval from the checkpoint: {name} proposals {p.shape}")
    print(f"[{path} path] eval --checkpoint model_best: recall@50 {recalls[0]:.4f} "
          f"on 2 scenes", flush=True)
    require_launches(eval_launches, OBB_EVAL_KERNELS if rotated else EVAL_KERNELS,
                     f"{path} eval-from-checkpoint", absent=k3 if rotated else ())
    for k, v in eval_launches.items():
        launches[k] += v
    return launches, data, common


def time_train_steps(torch, data, common, steps=20, warmup=3, fcos=False):
    """Device ms per train step (CUDA events around each step), the peak
    device memory and, for one more step under ``torch.profiler``, the
    device-busy ms and kernels, at the train path's shape on its first
    batch (the FCOS step with ``fcos``, ``common`` then holding its
    flags); K1 and K2 must run once per Swin block and step, and no hand
    kernel in a ResNet / VGG step."""
    import numpy as np

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.data.datasets import batch_iterator
    from nerf_rpn_tpu_torch.cli import run_fcos, run_rpn
    from nerf_rpn_tpu_torch.models.swin import SWIN_VARIANTS
    from nerf_rpn_tpu_torch.train.state import TrainState
    from nerf_rpn_tpu_torch.train.steps import make_fcos_train_step, make_rpn_train_step

    cli = run_fcos if fcos else run_rpn
    args = cli.parse_args(["--mode", "train", *common, "--num_workers", "0",
                           "--save_path", os.path.join(os.path.dirname(data), "timed")])
    trainer = cli.Trainer(args)
    train_set, _, _ = cli.common.build_datasets(args, "train", augment=False)
    host = next(iter(batch_iterator(
        train_set, args.batch_size, shuffle=False, drop_last=True,
        pad_multiple=args.pad_multiple, max_gt=args.max_gt,
        box_dim=7 if args.rotated_bbox else 6,
        fixed_shape=trainer.mesh_shape, num_workers=0)))
    batch = cli.common.device_batch(host, trainer.device, trainer.dtype)
    state = TrainState(trainer.model, args.lr, steps + warmup, args.weight_decay,
                       args.clip_grad_norm)
    gen = torch.Generator(trainer.device).manual_seed(0)
    drop = torch.Generator(trainer.device).manual_seed(1)
    if fcos:
        fcos_step = make_fcos_train_step(trainer.model, trainer.cfg, trainer.mesh_shape,
                                         device=trainer.device)

        def step(state, batch, gen, drop):
            return fcos_step(state, batch, drop)
    else:
        step = make_rpn_train_step(trainer.model, trainer.cfg_train, trainer.mesh_shape,
                                   run_rpn.STRIDES, device=trainer.device)
    for _ in range(warmup):
        step(state, batch, gen, drop)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(steps)]
    losses = []
    t0 = time.perf_counter()
    for a, b in events:
        a.record()
        losses.append(step(state, batch, gen, drop)["loss"])
        b.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    per_step = {k: v / steps for k, v in kernels.counts().items() if v}
    # a Swin step runs K1 and K2 once a block; a CNN step no hand kernel
    blocks = sum(SWIN_VARIANTS.get(args.backbone_type, {"depths": ()})["depths"])
    want = {"window_attention_fwd": blocks, "window_attention_bwd": blocks} if blocks else {}
    if per_step != want:
        fail(f"timed train steps: launches per step {per_step}, expected {want}")
    ms = np.array([a.elapsed_time(b) for a, b in events])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    busy_ms, busy_kernels = device_busy(torch, lambda: step(state, batch, gen, drop))
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.all(np.isfinite(losses)):
        fail(f"timed train steps: non-finite losses {losses}")
    row = {"head": "fcos" if fcos else "rpn", "backbone": args.backbone_type,
           "rotated": args.rotated_bbox,
           "shape": list(trainer.mesh_shape),
           "batch": args.batch_size, "steps": steps, "launches_per_step": per_step,
           "ms_per_step_mean": float(ms.mean()), "ms_per_step_median": float(np.median(ms)),
           "ms_per_step_min": float(ms.min()), "ms_per_step_max": float(ms.max()),
           "wall_ms_per_step": wall_ms, "peak_mem_gib": peak_gib,
           "device_busy_ms_one_step": busy_ms, "kernels_one_step": busy_kernels,
           "loss_first": float(losses[0]), "loss_last": float(losses[-1])}
    print("[train steps]", json.dumps(row), flush=True)
    return row


# ---------------------------------------------------------------------------
# The CNN backbones (ResNet / VGG) and the quality gate
# ---------------------------------------------------------------------------

# a ResNet / VGG eval scene runs K3 and the resolve kernel once (AABB
# propose) and no Swin kernel; a train step runs none
CNN_EVAL_LAUNCHES_PER_SCENE = {"aabb_suppression_graph": 1.0, "nms_resolve": 1.0}
SWIN_KERNELS = ("window_attention_fwd", "window_attention_bwd", "fused_window_attention",
                "ln_partition_qkv", "fused_mlp_block")
# run_rpn --mode benchmark's scene (bench.py's resnet / vgg_AF / vgg_EF rows)
CNN_BENCH_BACKBONES = ("resnet", "vgg_AF", "vgg_EF")


def _cnn_pair(torch, dev, backbone, seed, x):
    """The same ``backbone`` (f32, random weights, running statistics that
    are not 0 / 1) on the CPU and on the card.  The class logits are
    scaled to a largest |logit| of 4 on ``x`` (the init gives ~1e-4,
    whose sigmoids tie to the ulp, and saturated ones tie at 1: the two
    devices' sigmoids then order such rows differently), the deltas by
    0.05 (boxes near their anchors)."""
    from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN, init_params

    cpu = NeRFRPN(backbone, conv_depth=2, resolution=160)
    init_params(cpu, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.copy_(torch.rand(m.running_mean.shape, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
        cpu.rpn_head.bbox_pred.weight.mul_(0.05)
        logits = cpu.eval()(x)[1]
        cpu.rpn_head.cls_logits.weight.mul_(4.0 / max(l.abs().max().item() for l in logits))
    gpu = NeRFRPN(backbone, conv_depth=2, resolution=160)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu.to(dev)


def same_proposal_sets(np, want, got, box_tol):
    """The worst box error between two propose outputs that keep the same
    proposals, or None.  Rows match by level, score (within 1e-6) and box
    (within ``box_tol``): two scores within an ulp of each other -- one
    device's sigmoid may tie what the other's separates -- may trade
    places, so the rows are compared as sets, each matched once."""
    worst = 0.0
    for b in range(want["valid"].shape[0]):
        w_valid, g_valid = want["valid"][b].cpu().numpy(), got["valid"][b].cpu().numpy()
        if w_valid.sum() != g_valid.sum():
            return None
        w = [t[b].float().cpu().numpy()[w_valid] for t in (want["scores"], want["boxes"])]
        g = [t[b].float().cpu().numpy()[g_valid] for t in (got["scores"], got["boxes"])]
        wl = want["level_idx"][b].cpu().numpy()[w_valid]
        gl = got["level_idx"][b].cpu().numpy()[g_valid]
        free = np.ones(len(gl), bool)
        for i in range(len(wl)):
            err = np.abs(g[1] - w[1][i]).max(axis=1)
            ok = free & (gl == wl[i]) & (np.abs(g[0] - w[0][i]) <= 1e-6) & (err <= box_tol)
            if not ok.any():
                return None
            j = int(np.flatnonzero(ok)[np.argmin(err[ok])])
            free[j] = False
            worst = max(worst, float(err[j]))
    return worst


def _unlike_scenes(np, n, shape, seed):
    """``n`` grids of unlike content: BatchNorm statistics over few deep
    voxels of near-equal scenes would be all rounding."""
    x = np.random.default_rng(seed).uniform(0, 1, (n, *shape, 4)).astype(np.float32)
    for i in range(1, n):
        x[i] *= np.linspace(0.2, 3.0, shape[0], dtype=np.float32)[:, None, None, None] * i
        x[i, shape[0] // 4:, : shape[1] // 2, :, 3] += 2.0
    return x


def check_cnn_small_slice(torch, dev):
    """``resnet_tiny`` and ``vgg_AF`` (the 160 stem rule) at 64^3, f32, the
    same weights and running statistics on the card and on the CPU: eval
    head outputs, proposals from the same head outputs, then one RPN train
    step at batch 2 with one injected anchor sample, in f64 and in f32 --
    the loss terms, every gradient leaf and the updated running statistics."""
    import numpy as np

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.models import rpn as rpn_lib
    from nerf_rpn_tpu_torch.train.steps import level_shapes_for, make_rpn_eval_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shape, strides = (64, 64, 64), (4, 8, 16, 32)
    cfg = rpn_lib.RPNConfig(pre_nms_top_n=600, post_nms_top_n=300)
    x = torch.from_numpy(_unlike_scenes(np, 1, shape, 2))
    ori = torch.tensor([[60, 56, 64]], dtype=torch.int32)
    gt = np.zeros((2, 8, 6), np.float32)
    gt[0, :3] = [[4, 6, 8, 28, 24, 36], [32, 32, 16, 56, 60, 40], [8, 40, 40, 24, 60, 62]]
    gt[1, :2] = [[0, 0, 0, 40, 32, 24], [20, 24, 28, 36, 40, 48]]
    batch = {"grids": torch.from_numpy(_unlike_scenes(np, 2, shape, 4)),
             "gt_boxes": torch.from_numpy(gt), "gt_mask": torch.from_numpy(gt[..., 3] > 0),
             "ori_sizes": torch.tensor([[64, 60, 64], [56, 64, 52]], dtype=torch.int32)}
    shapes = level_shapes_for(shape, strides)
    anchors, _, level_strides, _ = rpn_lib.build_level_tables(cfg, shape, shapes)
    pad = rpn_lib.dynamic_padding_masks(shapes, level_strides, 13, batch["ori_sizes"])
    matches = rpn_lib.assign_anchors(cfg, torch.from_numpy(anchors), batch["gt_boxes"],
                                     batch["gt_mask"], pad)
    indices = rpn_lib.sample_anchors(cfg, matches, torch.Generator().manual_seed(0))
    for seed, backbone in enumerate(("resnet_tiny", "vgg_AF")):
        cpu, gpu = _cnn_pair(torch, dev, backbone, seed, x)
        kernels.reset_counts()
        c_step = make_rpn_eval_step(cpu.eval(), cfg, shape)
        g_step = make_rpn_eval_step(gpu.eval(), cfg, shape, device=dev)
        _, c_obj, c_dl, _ = c_step.forward(x)
        _, g_obj, g_dl, _ = g_step.forward(x.to(dev))
        worst = 0.0
        for c, g in zip(c_obj + c_dl, g_obj + g_dl):
            err = (g.cpu() - c).abs().max().item()
            worst = max(worst, err / (1.0 + c.abs().max().item()))
            # f32 convolutions of other algorithms (TF32 off): 1e-4
            if not err <= 1e-4 * (1.0 + c.abs().max().item()):
                fail(f"{backbone} small slice: head outputs differ by {err}")
        c_out = c_step.propose(c_obj, c_dl, ori)
        g_out = g_step.propose([t.to(dev) for t in c_obj], [t.to(dev) for t in c_dl],
                               ori.to(dev))
        box_err = same_proposal_sets(np, c_out, g_out, 1e-6 * shape[0])
        if box_err is None:
            fail(f"{backbone} small slice: the proposals differ from the CPU run's")
        launches = kernels.counts()
        # the card's propose: K3 and the resolve kernel once (none on a CPU rehearsal)
        if dev.type == "cuda" and (launches["aabb_suppression_graph"] != 1
                                   or launches["nms_resolve"] != 1):
            fail(f"{backbone} small slice: launches {launches}")
        print(f"[cnn small slice] {backbone}: head max|err| / (1 + max) {worst:.3g}, proposals: "
              f"the same set, boxes max|err| {box_err:.3g}, "
              f"{int(c_out['valid'].sum())} valid", flush=True)

        cpu_grads = {}
        for dtype in (torch.float64, torch.float32):
            readings, cpu_grads[dtype] = _cnn_train_step_readings(
                torch, dev, cpu, cfg, shape, strides, batch, indices, dtype)
            compared = readings.pop("compared")
            if dtype == torch.float32:
                # for scale: how far the CPU's own f32 step is from its f64 step
                off = [((cpu_grads[dtype][n] - cpu_grads[torch.float64][n]).abs().max()
                        / cpu_grads[torch.float64][n].abs().max()).item() for n in compared]
                readings["cpu_f32_off_f64_median_leaf"] = float(np.median(off))
                readings["cpu_f32_off_f64_worst_leaf"] = max(off)
            limits = CNN_TRAIN_STEP_LIMITS[dtype_name(dtype)]
            print(f"[cnn small train step] {backbone} {dtype_name(dtype)}: "
                  + json.dumps(readings), flush=True)
            for key, limit in limits.items():
                if not readings[key] <= limit:
                    fail(f"{backbone} small train step, {dtype_name(dtype)}: {key} "
                         f"{readings[key]} over its limit {limit}")


# The card's train step against the CPU's on the same weights, batch and
# anchor sample.  f64 holds the arithmetic tight.  f32 is the precision the
# drivers train in; there flax's E[x^2] - E[x]^2 over the deep stages' few
# values a channel is ill-conditioned (``cpu_f32_off_f64_*`` prints how far
# the CPU's own f32 step is from its f64 step), so the f32 gradient limits
# sit ~3.5x over the card's readings (PERF.md, PR 13: worst leaf 2.8e-2 and
# median 3.1e-4 on vgg_AF), and the loss terms and running statistics stay
# tight.  Each reading is relative: a loss term to the CPU's value, a
# gradient leaf and a running statistic to the CPU's largest entry of that
# leaf, the gradient of a conv bias ahead of a BatchNorm (0 but for
# rounding: the bias cancels in the batch mean) to the largest entry of any
# leaf.
CNN_TRAIN_STEP_LIMITS = {
    "float64": {"loss_terms": 1e-6, "grad_norm": 1e-6, "grad_worst_leaf": 1e-6,
                "grad_median_leaf": 1e-6, "cancelled_bias_grad": 1e-4, "running_stats": 1e-9},
    "float32": {"loss_terms": 1e-5, "grad_norm": 1e-4, "grad_worst_leaf": 0.1,
                "grad_median_leaf": 1e-3, "cancelled_bias_grad": 1e-4, "running_stats": 1e-5},
}


def _cnn_train_step_readings(torch, dev, cpu, cfg, shape, strides, batch, indices, dtype):
    """One RPN train step of ``cpu``'s weights in ``dtype`` on the CPU and on
    the card, with the anchor sample ``indices`` injected; returns the
    worst relative differences (see ``CNN_TRAIN_STEP_LIMITS``), the worst
    gradient leaf's name and the compared leaves, and the CPU's
    gradients."""
    import numpy as np

    from nerf_rpn_tpu_torch.models.nerf_rpn import NeRFRPN
    from nerf_rpn_tpu_torch.train.state import TrainState
    from nerf_rpn_tpu_torch.train.steps import make_rpn_train_step

    results = []
    for d in (torch.device("cpu"), dev):
        model = NeRFRPN(cpu.backbone_type, conv_depth=2, resolution=160, dtype=dtype)
        model.load_state_dict(cpu.state_dict())
        model.to(d, dtype)
        state = TrainState(model, 1e-3, 10)
        grads, apply = {}, state.apply_gradients

        def capture(model=model, grads=grads, apply=apply):
            # a copy: the update that follows may scale the gradients in place
            grads.update({n: p.grad.detach().to("cpu", torch.float64, copy=True)
                          for n, p in model.named_parameters()})
            return apply()

        state.apply_gradients = capture
        step = make_rpn_train_step(model, cfg, shape, strides, device=d)
        metrics = step(state, {k: v.to(d, dtype) if k == "grids" else v.to(d)
                               for k, v in batch.items()},
                       torch.Generator(d).manual_seed(0), torch.Generator(d).manual_seed(1),
                       indices=[t.to(d) for t in indices])
        stats = {n: b.detach().to("cpu", torch.float64, copy=True) for n, b in model.named_buffers()
                 if "running_" in n}
        results.append(({k: float(v) for k, v in metrics.items()}, grads, stats))
    (c_m, c_g, c_s), (g_m, g_g, g_s) = results
    rel = {}
    for k in ("loss", "loss_objectness", "loss_rpn_box_reg", "grad_norm"):
        if not np.isfinite(g_m[k]):
            fail(f"{cpu.backbone_type} small train step: {k} is {g_m[k]} on the card")
        rel[k] = abs(g_m[k] - c_m[k]) / abs(c_m[k])
    top = max(v.abs().max().item() for v in c_g.values())
    # a conv bias that feeds a BatchNorm cancels in its mean
    cancelled = {f"{name}.{i}.bias" for name, seq in cpu.named_modules()
                 if isinstance(seq, torch.nn.Sequential)
                 for i, (a, b) in enumerate(zip(seq, list(seq)[1:]))
                 if isinstance(a, torch.nn.Conv3d) and a.bias is not None
                 and isinstance(b, torch.nn.BatchNorm3d)}
    leaf_errs, cancelled_worst = {}, 0.0
    for name, c in c_g.items():
        scale = c.abs().max().item()
        err = (g_g[name] - c).abs().max().item()
        if name in cancelled:
            cancelled_worst = max(cancelled_worst, scale / top, g_g[name].abs().max().item() / top)
            continue
        if scale == 0:
            if err != 0:
                fail(f"{cpu.backbone_type} small train step: gradient {name} should be 0")
            continue
        leaf_errs[name] = err / scale
    worst_leaf = max(leaf_errs, key=leaf_errs.get)
    stat_err = max((g_s[n] - c).abs().max().item() / c.abs().max().item()
                   for n, c in c_s.items())
    return {"loss_terms": max(rel["loss"], rel["loss_objectness"], rel["loss_rpn_box_reg"]),
            "grad_norm": rel["grad_norm"], "grad_worst_leaf": leaf_errs[worst_leaf],
            "grad_median_leaf": float(np.median(list(leaf_errs.values()))),
            "cancelled_bias_grad": cancelled_worst, "running_stats": stat_err,
            "worst_leaf": worst_leaf, "leaves": len(leaf_errs), "buffers": len(c_s),
            "compared": sorted(leaf_errs), "loss_cpu": c_m["loss"],
            "loss_card": g_m["loss"]}, c_g


def run_cnn_benchmarks(torch):
    """``run_rpn --mode benchmark --bf16 --pad_multiple 16`` with ``resnet``,
    ``vgg_AF`` and ``vgg_EF`` at 208x208x144 (``bench.py``'s three CNN
    inference rows, nothing cut), then ``run_fcos --mode benchmark
    --backbone_type resnet`` at 160^3: ms a scene and the launches a scene
    (K3 1, resolve 1, every Swin kernel 0)."""
    import numpy as np

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.cli import run_fcos, run_rpn

    total = {}
    runs = [(f"{b} eval", run_rpn, ["--backbone_type", b, "--pad_multiple", "16"])
            for b in CNN_BENCH_BACKBONES]
    runs.append(("fcos resnet eval", run_fcos, ["--backbone_type", "resnet", *FCOS_FLAGS]))
    rows = {}
    for path, cli, argv in runs:
        kernels.reset_counts()
        bench = cli.main(["--mode", "benchmark", "--bf16", "--device", "cuda", *argv])
        torch.cuda.synchronize()
        launches = kernels.counts()
        times = [bench[k] for k in ("forward_ms", "propose_ms", "total_ms")]
        if not all(np.isfinite(times)) or bench["valid_proposals"] <= 0:
            fail(f"{path} benchmark {bench}")
        scenes = bench["reps"] + bench["warmup"]
        per_scene = {k: v / scenes for k, v in launches.items() if v}
        if per_scene != CNN_EVAL_LAUNCHES_PER_SCENE:
            fail(f"{path}: launches per scene {per_scene}, expected "
                 f"{CNN_EVAL_LAUNCHES_PER_SCENE}")
        print(f"[{path} path] benchmark {bench['shape']} bf16, {bench['reps']} reps: "
              f"forward {bench['forward_ms']:.3f} ms/scene, propose "
              f"{bench['propose_ms']:.3f} ms/scene, whole {bench['total_ms']:.3f} "
              f"ms/scene (median {bench['total_median_ms']:.3f}, "
              f"p{bench['tail_percentile']:.1f} {bench['total_tail_ms']:.3f}); launches "
              f"per scene {json.dumps(per_scene)}", flush=True)
        rows[path] = bench
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total, rows


def run_cnn_train_path(torch, workdir, resolution=160, backbone="resnet", device="cuda"):
    """``run_rpn --mode train --backbone_type resnet --bf16`` on the train
    path's synthetic 160^3 scenes (batch 2, one epoch, validation eval,
    checkpoints; no Swin kernel, K3 and the resolve kernel in the
    validation eval), then ``--mode eval --checkpoint <save>/model_best``,
    whose restored running statistics must equal the saved ones."""
    import numpy as np

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.cli import run_rpn

    path = f"{backbone} train"
    data, common = write_train_data(workdir, resolution, backbone, device)
    save = os.path.join(workdir, f"{backbone}_train")
    t0 = time.perf_counter()
    kernels.reset_counts()
    logged = run_rpn.main(["--mode", "train", "--num_epochs", "1", "--log_interval", "1",
                           "--save_path", save, *common])
    torch.cuda.synchronize()
    launches = kernels.counts()
    train_s = time.perf_counter() - t0
    keys = ("loss", "loss_objectness", "loss_rpn_box_reg", "grad_norm", "param_norm")
    if len(logged) != 2:
        fail(f"{path} path: expected 2 logged steps, got {len(logged)}")
    for m in logged:
        if not (np.all(np.isfinite([m[k] for k in keys])) and m["loss"] > 0):
            fail(f"{path} path: bad metrics {m}")
    for name in ("model_best", "epoch_1", "model_best.args.json"):
        if not os.path.isfile(os.path.join(save, name)):
            fail(f"{path} path: {name} was not written")
    # the validation eval's 2 scenes: K3 and the resolve kernel once each
    require_launches(launches, ("aabb_suppression_graph", "nms_resolve"), path,
                     absent=SWIN_KERNELS)
    saved = torch.load(os.path.join(save, "model_best"), map_location="cpu", weights_only=True)
    stats = {k: v for k, v in saved["backbone_state_dict"].items()
             if "running_" in k or k.endswith("num_batches_tracked")}
    if not stats or any(int(v) != 2 for k, v in stats.items() if k.endswith("tracked")):
        fail(f"{path} path: the checkpoint's BatchNorm statistics do not show 2 steps")
    print(f"[{path} path] 1 epoch, 2 steps + validation eval in {train_s:.1f} s; losses "
          + ", ".join(f"{m['loss']:.4f}" for m in logged)
          + f"; {len(stats)} BatchNorm buffers saved", flush=True)

    kernels.reset_counts()
    argv = ["--mode", "eval", "--checkpoint", os.path.join(save, "model_best"),
            "--save_path", save + "_eval_ckpt", "--output_proposals", *common]
    trainer = run_rpn.Trainer(run_rpn.parse_args(argv))
    restored = {k: v.cpu() for k, v in trainer.model.backbone.state_dict().items() if k in stats}
    if restored.keys() != stats.keys() or not all(torch.equal(restored[k], v)
                                                  for k, v in stats.items()):
        fail(f"{path} eval from the checkpoint: restored running statistics differ")
    recalls, _ = trainer.eval(run_rpn.common.build_datasets(trainer.args, "eval", False)[2])
    torch.cuda.synchronize()
    eval_launches = kernels.counts()
    files = sorted(os.listdir(os.path.join(save + "_eval_ckpt", "proposals")))
    if len(files) != 2 or not np.all(np.isfinite(recalls)):
        fail(f"{path} eval from the checkpoint: files {files}, recalls {recalls}")
    print(f"[{path} path] eval --checkpoint model_best: running statistics restored equal "
          f"({len(stats)} buffers), recall@50 {recalls[0]:.4f} on 2 scenes", flush=True)
    require_launches(eval_launches, ("aabb_suppression_graph", "nms_resolve"),
                     f"{path} eval-from-checkpoint", absent=SWIN_KERNELS)
    for k, v in eval_launches.items():
        launches[k] += v
    return launches, data, common


# ---------------------------------------------------------------------------
# The RCNN second stage (run_rpn_detect)
# ---------------------------------------------------------------------------

# ``scripts/train_rcnn.sh``'s flags (its run length, logging and eval
# intervals aside: one epoch, a log line a step)
RCNN_TRAIN_FLAGS = ["--fine_tune", "--backbone_type", "swin", "--lr", "1e-4",
                    "--reg_loss_weight", "5.", "--weight_decay", "1e-4", "--clip_grad_norm", "1",
                    "--keep_checkpoints", "5", "--n_classes", "2", "--output_size", "3", "3", "3",
                    "--spatial_scale", "4", "8", "16", "32", "--is_add_layer", "--is_flatten",
                    "--rotated_bbox", "--cls_batch_size", "256", "--batch_size", "2",
                    "--fg_threshold", "0.25", "--bg_threshold", "0.25",
                    "--backbone_input_dim", "4", "--resolution", "200"]
SCALES = (4, 8, 16, 32)


def _rcnn_batch(torch, feats, rois, levels, dev):
    """A features-mode batch: per-level (B, X, Y, Z, C) features, (B, R, D)
    RoIs and levels, all valid, one gt box a scene (the first RoI)."""
    b, r = rois.shape[:2]
    return {"features": [f.to(dev) for f in feats], "rois": torch.from_numpy(rois).to(dev),
            "roi_levels": torch.from_numpy(levels).to(dev),
            "roi_valid": torch.ones((b, r), dtype=torch.bool, device=dev),
            "gt_boxes": torch.from_numpy(rois[:, :2].copy()).to(dev),
            "gt_mask": torch.ones((b, 2), dtype=torch.bool, device=dev)}


def _random_rois(np, rng, b, r, mesh, rotated, size=(8, 60)):
    """``r`` RoIs a scene in a ``mesh``-sized grid (mesh units) with sides
    in ``size``, and their FPN levels (``--remap``'s mapper)."""
    from nerf_rpn_tpu_torch.ops.roi_align import map_rois_to_levels_np

    mesh = np.asarray(mesh, np.float32)
    size = rng.uniform(*size, (b, r, 3)).astype(np.float32)
    ctr = rng.uniform(0, 1, (b, r, 3)).astype(np.float32) * mesh
    if rotated:
        rois = np.concatenate([ctr, size, rng.uniform(-1.5, 1.5, (b, r, 1)).astype(np.float32)],
                              -1)
    else:
        rois = np.concatenate([ctr - size / 2, ctr + size / 2], -1)
    return rois, map_rois_to_levels_np(rois, 0, 3, canonical_scale=64)


def check_rcnn_small_slice(torch, dev):
    """The RCNN second stage on the card against the CPU, same weights
    (f32, TF32 off).  Features mode at ``train_rcnn.sh``'s head (256
    channels, 3^3, ``--is_add_layer --is_flatten``), AABB and OBB, on
    random FPN levels of a 200x200x136 scene pair: pooled features, eval
    scores and refined boxes, and the filter's keep-sets and orders on the
    same inputs (equal).  Fine-tune ``resnet_tiny`` at 32^3: eval scores
    and boxes, then one train step with an injected sample in f64 and in
    f32 (loss terms, every gradient leaf, running statistics; phase 18's
    limits)."""
    import numpy as np

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.models.detector import RCNNConfig, RCNNDetector, RCNNHead
    from nerf_rpn_tpu_torch.models.nerf_rpn import build_backbone, init_params
    from nerf_rpn_tpu_torch.ops.roi_align import multilevel_roi_align_batched
    from nerf_rpn_tpu_torch.train.steps import make_rcnn_eval_step, make_rcnn_filter_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_dev = torch.device("cpu")
    rng = np.random.default_rng(7)
    mesh = (200, 200, 136)
    feats = [torch.from_numpy(rng.standard_normal((2, *(-(-m // s) for m in mesh), 256))
                              .astype(np.float32)) for s in SCALES]
    for rotated in (False, True):
        form = "obb" if rotated else "aabb"
        cfg = RCNNConfig(rotated=rotated, output_size=(3, 3, 3), fg_threshold=0.25,
                         bg_threshold=0.25, pool_mode="max")
        cpu = RCNNDetector(RCNNHead(256, 2, rotated, True, True, (3, 3, 3)))
        init_params(cpu, torch.Generator().manual_seed(3 + rotated))
        gpu = RCNNDetector(RCNNHead(256, 2, rotated, True, True, (3, 3, 3)))
        gpu.load_state_dict(cpu.state_dict())
        gpu.to(dev)
        rois, levels = _random_rois(np, rng, 2, 64, mesh, rotated)
        c_batch = _rcnn_batch(torch, feats, rois, levels, cpu_dev)
        g_batch = _rcnn_batch(torch, feats, rois, levels, dev)
        args = (SCALES, cfg.output_size, cfg.sampling_ratio, cfg.pool_mode, rotated,
                cfg.enlarge_scale)
        c_pool = multilevel_roi_align_batched(c_batch["features"], c_batch["rois"],
                                              c_batch["roi_levels"], c_batch["roi_valid"], *args)
        g_pool = multilevel_roi_align_batched(g_batch["features"], g_batch["rois"],
                                              g_batch["roi_levels"], g_batch["roi_valid"], *args)
        pool_err = (g_pool.cpu() - c_pool).abs().max().item() / c_pool.abs().max().item()
        # the same gathers; sample coordinates from cos/sin of an ulp apart
        if not pool_err <= 1e-5:
            fail(f"rcnn small slice {form}: pooled features differ by {pool_err}")
        c_out = make_rcnn_eval_step(cpu.eval(), cfg, SCALES)(c_batch)
        g_out = make_rcnn_eval_step(gpu.eval(), cfg, SCALES)(g_batch)
        errs = {}
        for k in ("scores", "refined_boxes"):
            c, g = c_out[k], g_out[k].cpu()
            errs[k] = ((g - c).abs().amax(-1) / (1.0 + c.abs().amax(-1))).max().item()
            # f32 through two 3^3 convs (cuDNN vs the CPU's sum orders)
            if not errs[k] <= 1e-4:
                fail(f"rcnn small slice {form}: {k} differ by {errs[k]}")
        if not torch.equal(g_out["labels"].cpu(), c_out["labels"]):
            fail(f"rcnn small slice {form}: labels differ")
        mesh_sizes = torch.tensor([mesh, mesh], dtype=torch.float32)
        filt = make_rcnn_filter_step(cfg, 0.5, 0.1, 300)
        inputs = (c_out["refined_boxes"], c_out["scores"], c_out["valid"], mesh_sizes)
        kernels.reset_counts()
        g_f = filt(*(t.to(dev) for t in inputs))
        torch.cuda.synchronize()
        launches = kernels.counts()
        c_f = filt(*inputs)
        if not (torch.equal(g_f[1].cpu(), c_f[1]) and torch.equal(g_f[2].cpu(), c_f[2])
                and (g_f[0].cpu() - c_f[0]).abs().max().item() <= 1e-6 * mesh[0]):
            fail(f"rcnn small slice {form}: the filter's keep, order or boxes differ from "
                 "the CPU's")
        want = {"nms_resolve": 2, "aabb_suppression_graph": 0 if rotated else 2}
        if dev.type == "cuda" and any(launches[k] != v for k, v in want.items()):
            fail(f"rcnn small slice {form}: filter launches {launches}, expected {want}")
        print(f"[rcnn small slice] features {form}: pooled max|err|/max {pool_err:.3g}, "
              f"scores {errs['scores']:.3g}, refined boxes {errs['refined_boxes']:.3g}, "
              f"filter: keep and order equal ({int(c_f[1].sum())} kept of 128)", flush=True)

    # fine-tune resnet_tiny at 32^3
    cfg = RCNNConfig(output_size=(2, 2, 2), fg_threshold=0.3, bg_threshold=0.25)
    cpu = RCNNDetector(RCNNHead(32, 2, False, False, True, (2, 2, 2)),
                       build_backbone("resnet_tiny", 32))
    init_params(cpu, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.copy_(torch.rand(m.running_mean.shape, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    gpu = RCNNDetector(RCNNHead(32, 2, False, False, True, (2, 2, 2)),
                       build_backbone("resnet_tiny", 32))
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    rois, levels = _random_rois(np, rng, 2, 48, (32, 32, 32), False, size=(3, 12))
    gt = np.stack([rois[0, :2], rois[1, :2]]) + 0.5
    rois[:, 2:6] = np.repeat(gt, 2, 1) + rng.uniform(-0.6, 0.6, (2, 4, 6)).astype(np.float32)
    host = {"grids": torch.from_numpy(_unlike_scenes(np, 2, (32, 32, 32), 9)),
            "rois": torch.from_numpy(rois), "roi_levels": torch.from_numpy(levels),
            "roi_valid": torch.ones((2, 48), dtype=torch.bool), "gt_boxes": torch.from_numpy(gt),
            "gt_mask": torch.ones((2, 2), dtype=torch.bool)}
    c_out = make_rcnn_eval_step(cpu.eval(), cfg, SCALES)(host)
    g_out = make_rcnn_eval_step(gpu.eval(), cfg, SCALES)({k: v.to(dev) for k, v in host.items()})
    errs = {k: ((g_out[k].cpu() - c_out[k]).abs().amax(-1)
                / (1.0 + c_out[k].abs().amax(-1))).max().item()
            for k in ("scores", "refined_boxes")}
    if not max(errs.values()) <= 1e-4:
        fail(f"rcnn small slice fine-tune: eval outputs differ {errs}")
    print(f"[rcnn small slice] fine-tune resnet_tiny eval: scores {errs['scores']:.3g}, "
          f"refined boxes {errs['refined_boxes']:.3g}", flush=True)
    from nerf_rpn_tpu_torch.models.detector import sample_rois
    indices = sample_rois(cfg, torch.Generator().manual_seed(0), host["rois"],
                          host["roi_levels"], host["roi_valid"], host["gt_boxes"],
                          host["gt_mask"], 16)["indices"]
    runs = {dtype: _rcnn_train_steps(torch, dev, cpu, cfg, host, indices, dtype)
            for dtype in (torch.float64, torch.float32)}
    for dtype, (c_run, g_run) in runs.items():
        readings = _rcnn_step_readings(np, c_run, g_run)
        limits = dict(CNN_TRAIN_STEP_LIMITS[dtype_name(dtype)])
        if dtype == torch.float32:
            # the last level is 1^3 at 32^3: its train-mode BatchNorm
            # normalises 2 values a channel, so f32 is far from exact on
            # any device.  The card's f32 step may be as far from the CPU's
            # as twice the CPU's own f32 step is from its f64 step.
            own = _rcnn_step_readings(np, runs[torch.float64][0], c_run)
            readings.update({f"cpu_f32_off_f64_{k}": own[k] for k in limits if k in own})
            limits = {k: max(v, 2 * own[k]) for k, v in limits.items() if k in own}
        print(f"[rcnn small train step] resnet_tiny {dtype_name(dtype)}: "
              + json.dumps({**readings, "limits": limits}), flush=True)
        for key, limit in limits.items():
            if key in readings and not readings[key] <= limit:
                fail(f"rcnn small train step, {dtype_name(dtype)}: {key} {readings[key]} over "
                     f"its limit {limit}")


def _rcnn_train_steps(torch, dev, cpu, cfg, host, indices, dtype):
    """One fine-tune RCNN train step of ``cpu``'s weights in ``dtype`` with
    the RoI sample ``indices``, on the CPU and on the card: for each, its
    metrics, gradients and running statistics (f64 CPU copies)."""
    from nerf_rpn_tpu_torch.models.detector import RCNNDetector, RCNNHead
    from nerf_rpn_tpu_torch.models.nerf_rpn import build_backbone
    from nerf_rpn_tpu_torch.train.state import TrainState
    from nerf_rpn_tpu_torch.train.steps import make_rcnn_train_step

    results = []
    for d in (torch.device("cpu"), dev):
        model = RCNNDetector(RCNNHead(32, 2, False, False, True, (2, 2, 2), dtype),
                             build_backbone("resnet_tiny", 32, dtype))
        model.load_state_dict(cpu.state_dict())
        model.to(d, dtype)
        state = TrainState(model, 1e-3, 10)
        grads, apply = {}, state.apply_gradients

        def capture(model=model, grads=grads, apply=apply):
            # a copy: the update that follows may scale the gradients in place
            grads.update({n: p.grad.detach().to("cpu", torch.float64, copy=True)
                          for n, p in model.named_parameters()})
            return apply()

        state.apply_gradients = capture
        step = make_rcnn_train_step(model, cfg, SCALES, 16, reg_loss_weight=5.0)
        batch = {k: v.to(d, dtype) if v.is_floating_point() else v.to(d)
                 for k, v in host.items()}
        metrics = step(state, batch, None, indices=indices.to(d))
        stats = {n: b.detach().to("cpu", torch.float64, copy=True)
                 for n, b in model.named_buffers() if "running_" in n}
        results.append(({k: float(v) for k, v in metrics.items()}, grads, stats))
    return results


def _rcnn_step_readings(np, ref, got):
    """The worst relative differences of train-step result ``got`` from
    ``ref`` (as ``_cnn_train_step_readings``: loss terms to the value, a
    gradient leaf and a running statistic to ``ref``'s largest entry)."""
    (c_m, c_g, c_s), (g_m, g_g, g_s) = ref, got
    rel = {}
    for k in ("loss", "loss_objectness", "loss_rpn_box_reg", "grad_norm"):
        if not np.isfinite(g_m[k]):
            fail(f"rcnn small train step: {k} is {g_m[k]}")
        rel[k] = abs(g_m[k] - c_m[k]) / abs(c_m[k])
    leaf_errs = {n: (g_g[n] - c).abs().max().item() / c.abs().max().item()
                 for n, c in c_g.items() if c.abs().max().item() > 0}
    worst_leaf = max(leaf_errs, key=leaf_errs.get)
    return {"loss_terms": max(rel["loss"], rel["loss_objectness"], rel["loss_rpn_box_reg"]),
            "grad_norm": rel["grad_norm"], "grad_worst_leaf": leaf_errs[worst_leaf],
            "grad_median_leaf": float(np.median(list(leaf_errs.values()))),
            "running_stats": max((g_s[n] - c).abs().max().item() / c.abs().max().item()
                                 for n, c in c_s.items()),
            "worst_leaf": worst_leaf, "leaves": len(leaf_errs), "fg_rois": g_m["fg_rois"],
            "bg_rois": g_m["bg_rois"], "loss_ref": c_m["loss"], "loss": g_m["loss"]}


def _rcnn_common(data, rois, save, scenes_dir=None):
    """``run_rpn_detect``'s data arguments: grids or saved features from
    ``scenes_dir`` (default ``data``), gt boxes and the split from
    ``data`` (a later ``--dataset_split`` overrides it)."""
    return ["--features_path", scenes_dir or data, "--boxes_path", data, "--rois_path", rois,
            "--dataset_split", os.path.join(data, "split.npz"), "--save_path", save,
            "--device", "cuda"]


def _rcnn_launch_check(launches, path, steps, eval_batches, eval_scenes):
    """A train step runs K1 and K2 once a Swin block (24 each); an eval
    batch K5 24, K6 24, K4 12 and K1 12 (the backbone's eval route), and
    its filter the resolve kernel once a scene; OBBs never run K3."""
    want = {"window_attention_fwd": 24 * steps + 12 * eval_batches,
            "window_attention_bwd": 24 * steps, "ln_partition_qkv": 24 * eval_batches,
            "fused_mlp_block": 24 * eval_batches, "fused_window_attention": 12 * eval_batches,
            "nms_resolve": eval_scenes, "aabb_suppression_graph": 0}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"{path}: launches {got}, expected {want}")
    print(f"[{path}] launches {json.dumps(got)} ({steps} train steps, {eval_batches} eval "
          f"batches of {eval_scenes} scenes)", flush=True)


def run_rcnn_path(torch, workdir, rpn_ckpt):
    """``train_rcnn.sh``'s path: synthetic OBB scenes at 200x200x130 (4
    train, 2 validation, 2 test); their proposals and FPN levels from
    ``run_rpn --mode eval --rotated_bbox --save_results --output_all`` with
    the OBB RPN's ``model_best`` (``rpn_ckpt``); ``run_rpn_detect --mode
    train`` with every flag of the script, ``--pretrained rpn_ckpt``, one
    epoch with validation and checkpoints; ``--mode eval --checkpoint
    <save>/model_best --output_proposals``.  Returns the launches and the
    paths later phases read."""
    import numpy as np

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.cli import run_rpn, run_rpn_detect
    from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_dataset

    path = "rcnn train"
    data = os.path.join(workdir, "data200_obb")
    write_synthetic_dataset(data, n_train=4, n_val=2, n_test=2, resolution=(200, 200, 130),
                            seed=3, rotated=True, box_size=(20.0, 50.0))
    results = os.path.join(workdir, "rpn200_obb", "results")
    t0 = time.perf_counter()
    run_rpn.main(["--mode", "eval", "--checkpoint", rpn_ckpt, "--backbone_type", "swin_s",
                  "--bf16", "--rotated_bbox", "--resolution", "200", "--pad_multiple", "16",
                  "--device", "cuda",
                  "--features_path", data, "--boxes_path", data,
                  "--dataset_split", os.path.join(data, "split.npz"),
                  "--save_path", os.path.dirname(results), "--save_results", "--output_all"])
    torch.cuda.synchronize()
    n_rois = []
    for name in sorted(os.listdir(os.path.join(results, "proposals"))):
        with np.load(os.path.join(results, "proposals", name)) as z:
            n_rois.append(len(z["proposals"]))
    if len(n_rois) != 8 or min(n_rois) == 0:
        fail(f"{path}: stage-1 proposals of {len(n_rois)} scenes, {n_rois} RoIs")
    print(f"[{path}] stage 1 (run_rpn --save_results, OBB Swin-S model_best): {n_rois} RoIs "
          f"a scene in {time.perf_counter() - t0:.1f} s", flush=True)

    save = os.path.join(workdir, "rcnn")
    common = [*_rcnn_common(data, os.path.join(results, "proposals"), save), *RCNN_TRAIN_FLAGS]
    t0 = time.perf_counter()
    kernels.reset_counts()
    logged = run_rpn_detect.main(["--mode", "train", "--num_epochs", "1", "--log_interval", "1",
                                  "--eval_interval", "1", "--pretrained", rpn_ckpt, *common])
    torch.cuda.synchronize()
    launches = kernels.counts()
    keys = ("loss", "loss_objectness", "loss_rpn_box_reg", "grad_norm", "param_norm")
    if len(logged) != 2 or not all(np.all(np.isfinite([m[k] for k in keys])) for m in logged):
        fail(f"{path}: logged {logged}")
    for name in ("model_best", "epoch_1", "model_best.args.json", "eval.json"):
        if not os.path.isfile(os.path.join(save, name)):
            fail(f"{path}: {name} was not written")
    print(f"[{path}] 1 epoch, 2 steps + validation eval in {time.perf_counter() - t0:.1f} s; "
          + "; ".join(f"loss {m['loss']:.4f} (obj {m['loss_objectness']:.4f}, reg "
                      f"{m['loss_rpn_box_reg']:.4f}), sampled RoIs fg {m['fg_rois']:.0f} / bg "
                      f"{m['bg_rois']:.0f}" for m in logged), flush=True)
    _rcnn_launch_check(launches, path, steps=2, eval_batches=1, eval_scenes=2)

    kernels.reset_counts()
    out = os.path.join(workdir, "rcnn_eval")
    common_eval = [*_rcnn_common(data, os.path.join(results, "proposals"), out),
                   *RCNN_TRAIN_FLAGS]
    report = run_rpn_detect.main(["--mode", "eval", "--checkpoint",
                                  os.path.join(save, "model_best"), "--output_proposals",
                                  *common_eval])
    torch.cuda.synchronize()
    eval_launches = kernels.counts()
    files = sorted(os.listdir(os.path.join(out, "proposals")))
    metrics = [report["ap_25"]["ap"], report["ap_50"]["ap"],
               *report["classification"].values()]
    if len(files) != 2 or not np.all(np.isfinite(metrics)):
        fail(f"{path} eval: files {files}, metrics {report}")
    for name in files:
        with np.load(os.path.join(out, "proposals", name)) as z:
            if z["proposal"].ndim != 2 or z["proposal"].shape[1] != 7:
                fail(f"{path} eval: {name} proposals {z['proposal'].shape}")
    print(f"[{path}] eval --checkpoint model_best: AP@25 {report['ap_25']['ap']:.4f}, AP@50 "
          f"{report['ap_50']['ap']:.4f}, classification {json.dumps(report['classification'])}"
          f" on 2 scenes", flush=True)
    _rcnn_launch_check(eval_launches, f"{path} eval-from-checkpoint", steps=0, eval_batches=1,
                       eval_scenes=2)
    for k, v in eval_launches.items():
        launches[k] += v
    return launches, data, results, common


def time_rcnn_steps(torch, common, steps=20, warmup=3, scenes=10):
    """The fine-tune RCNN train step at ``train_rcnn.sh``'s shape: device
    ms a step (CUDA events), peak GiB, launches a step (K1 24, K2 24) and
    one profiled step's device-busy ms; then the eval a scene (batch 1)
    through the driver's eval and filter steps: ms of their parts, the
    backbone (``features``), RoI align (``pool``), head (``head``: labels,
    head, softmax, decode) and filter, by CUDA events, the device-busy ms
    of one whole scene, and its launches (K5 24, K6 24, K4 12, K1 12,
    resolve 1, K3 0)."""
    import numpy as np

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.cli import run_rpn_detect
    from nerf_rpn_tpu_torch.train.state import TrainState
    from nerf_rpn_tpu_torch.train.steps import (make_rcnn_eval_step, make_rcnn_filter_step,
                                                   make_rcnn_train_step)

    args = run_rpn_detect.parse_args(["--mode", "train", *common, "--num_workers", "0"])
    trainer = run_rpn_detect.Trainer(args)
    train_scenes, _, test_scenes = run_rpn_detect.load_split(args.dataset_split)
    train_set = trainer.dataset(train_scenes)
    host, _ = next(iter(trainer.batches(train_set)))
    batch = trainer.device_batch(host)
    state = TrainState(trainer.model, args.lr, steps + warmup, args.weight_decay,
                       args.clip_grad_norm)
    step = make_rcnn_train_step(trainer.model, trainer.cfg, trainer.spatial_scales,
                                args.cls_batch_size // args.batch_size,
                                reg_loss_weight=args.reg_loss_weight)
    gen = torch.Generator(trainer.device).manual_seed(0)
    drop = torch.Generator(trainer.device).manual_seed(1)
    for _ in range(warmup):
        step(state, batch, gen, drop)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(steps)]
    losses = []
    for a, b in events:
        a.record()
        losses.append(step(state, batch, gen, drop)["loss"])
        b.record()
    torch.cuda.synchronize()
    per_step = {k: v / steps for k, v in kernels.counts().items() if v}
    if per_step != {"window_attention_fwd": 24, "window_attention_bwd": 24}:
        fail(f"timed rcnn train steps: launches per step {per_step}")
    ms = np.array([a.elapsed_time(b) for a, b in events])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    busy_ms, busy_kernels = device_busy(torch, lambda: step(state, batch, gen, drop))
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.all(np.isfinite(losses)):
        fail(f"timed rcnn train steps: losses {losses}")
    row = {"shape": list(batch["grids"].shape[1:4]), "batch": args.batch_size, "steps": steps,
           "launches_per_step": per_step, "ms_per_step_mean": float(ms.mean()),
           "ms_per_step_median": float(np.median(ms)), "ms_per_step_min": float(ms.min()),
           "ms_per_step_max": float(ms.max()), "peak_mem_gib": peak,
           "device_busy_ms_one_step": busy_ms, "kernels_one_step": busy_kernels,
           "loss_first": float(losses[0]), "loss_last": float(losses[-1])}
    print("[rcnn train steps]", json.dumps(row), flush=True)

    # the eval a scene, by part
    trainer.args.batch_size = 1
    eval_step = make_rcnn_eval_step(trainer.model, trainer.cfg, trainer.spatial_scales)
    filt = make_rcnn_filter_step(trainer.cfg, args.filter_score_threhold, args.nms_thresh,
                                 int(args.filter_num_threhold))
    test_set = trainer.dataset(test_scenes)
    hosts = [h for h, _ in trainer.batches(test_set)]
    scene = [trainer.device_batch(h) for h in hosts]
    mesh = [torch.tensor(h["feat_shapes"] * trainer.spatial_scales[0], dtype=torch.float32,
                         device=trainer.device) for h in hosts]

    def parts(i):
        b = scene[i % len(scene)]
        feats = eval_step.features(b)
        yield "backbone"
        pooled = eval_step.pool(feats, b)
        yield "roi_align"
        out = eval_step.head(pooled, b)
        yield "head"
        filt(out["refined_boxes"], out["scores"], out["valid"], mesh[i % len(scene)])
        yield "filter"

    def whole(i):
        for _ in parts(i):
            pass

    for i in range(3):
        whole(i)
    torch.cuda.synchronize()
    kernels.reset_counts()
    names = ("backbone", "roi_align", "head", "filter")
    part_ms = {k: [] for k in names}
    scene_ms = []
    for i in range(scenes):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        for j, _ in enumerate(parts(i)):
            ev[j + 1].record()
        torch.cuda.synchronize()
        for j, k in enumerate(names):
            part_ms[k].append(ev[j].elapsed_time(ev[j + 1]))
        scene_ms.append(ev[0].elapsed_time(ev[4]))
    per_scene = {k: v / scenes for k, v in kernels.counts().items() if v}
    want = {k: v for k, v in OBB_EVAL_LAUNCHES_PER_SCENE.items()}
    if per_scene != want:
        fail(f"rcnn eval: launches per scene {per_scene}, expected {want}")
    busy, n_kernels = device_busy(torch, lambda: whole(0))
    eval_row = {"scene_ms_mean": float(np.mean(scene_ms)),
                "scene_ms_median": float(np.median(scene_ms)),
                **{f"{k}_ms_mean": float(np.mean(v)) for k, v in part_ms.items()},
                "device_busy_ms_one_scene": busy, "kernels_one_scene": n_kernels,
                "rois_a_scene": int(scene[0]["roi_valid"].sum()), "launches_per_scene": per_scene}
    print("[rcnn eval a scene]", json.dumps(eval_row), flush=True)
    return row, eval_row


def _features_split(np, data, workdir):
    """Phase 24's split of phase 23's scenes: its first 2 train scenes, its
    first validation scene and its 2 test scenes (a scene's saved levels
    load in ~9 s: ``level_features`` holds its values as Python floats,
    the JAX driver's layout)."""
    with np.load(os.path.join(data, "split.npz")) as z:
        split = {"train_scenes": z["train_scenes"][:2], "val_scenes": z["val_scenes"][:1],
                 "test_scenes": z["test_scenes"]}
    path = os.path.join(workdir, "split_features.npz")
    np.savez(path, **split)
    return path, split


def _aabb_copy(np, data, results, workdir):
    """The AABB form of phase 23's data: the gt OBBs' and the RoIs'
    enclosing boxes, beside the same saved levels."""
    import torch as _torch

    from nerf_rpn_tpu_torch.ops.obb import obb2hbb_3d

    out = os.path.join(workdir, "aabb_from_obb")
    rois = os.path.join(out, "rois")
    os.makedirs(rois, exist_ok=True)
    for name in os.listdir(data):
        if name.endswith(".npy"):
            gt = _torch.from_numpy(np.load(os.path.join(data, name)))
            np.save(os.path.join(out, name), obb2hbb_3d(gt).numpy())
    for name in os.listdir(os.path.join(results, "proposals")):
        with np.load(os.path.join(results, "proposals", name)) as z:
            box = obb2hbb_3d(_torch.from_numpy(z["proposals"])).numpy()
            np.savez(os.path.join(rois, name), proposals=box, level_indices=z["level_indices"])
    return out, rois


def run_rcnn_features_path(torch, workdir, data, results):
    """``run_rpn_detect`` without ``--fine_tune`` on phase 23's saved FPN
    levels (Swin-S, 256 channels), OBB and AABB (the enclosing boxes of the
    same gt and RoIs), on 2 train, 1 validation and 2 test scenes: one
    epoch with validation, then ``--mode eval --checkpoint model_best``;
    no hand kernel but the filter's (resolve once a scene, K3 once a scene
    for AABBs).  Then RoI align alone at 2 x 1024 RoIs of these levels
    (the OBB RoIs and their enclosing boxes): device ms (``time_one``)
    against its bound (the feature rows its samples touch, read once, the
    RoIs and the output; 136 f32 operations a bin and channel),
    ``train_rcnn.sh``'s 3^3 bins and 2^3 samples, max (the driver's
    default) and avg."""
    import numpy as np

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.cli import run_rpn_detect
    from nerf_rpn_tpu_torch.ops.obb import obb2hbb_3d
    from nerf_rpn_tpu_torch.ops.roi_align import multilevel_roi_align_batched

    feats_dir = os.path.join(results, "features")
    split, scenes = _features_split(np, data, workdir)
    aabb_data, aabb_rois = _aabb_copy(np, data, results, workdir)
    launches, common_of = None, {}
    for form, d, rois in (("obb", data, os.path.join(results, "proposals")),
                          ("aabb", aabb_data, aabb_rois)):
        path = f"rcnn features {form}"
        save = os.path.join(workdir, f"rcnn_features_{form}")
        common = [*_rcnn_common(d, rois, save, feats_dir), "--dataset_split", split,
                  "--output_size", "3", "3", "3", "--is_add_layer", "--is_flatten",
                  "--cls_batch_size", "256", "--batch_size", "2", "--fg_threshold", "0.25",
                  "--bg_threshold", "0.25", *(["--rotated_bbox"] if form == "obb" else [])]
        common_of[form] = common
        kernels.reset_counts()
        t0 = time.perf_counter()
        logged = run_rpn_detect.main(["--mode", "train", "--num_epochs", "1",
                                      "--log_interval", "1", *common])
        report = run_rpn_detect.main(["--mode", "eval", "--checkpoint",
                                      os.path.join(save, "model_best"), *common])
        torch.cuda.synchronize()
        got = kernels.counts()
        if len(logged) != 1 or not np.isfinite(logged[0]["loss"]):
            fail(f"{path}: logged {logged}")
        if not np.isfinite(report["classification"]["accuracy"]):
            fail(f"{path}: eval {report}")
        # the validation batch (1 scene, padded to 2) and the 2 test scenes
        want = {"nms_resolve": 4, "aabb_suppression_graph": 4 if form == "aabb" else 0}
        if any(got[k] != v for k, v in want.items()) or any(got[k] for k in SWIN_KERNELS):
            fail(f"{path}: launches {got}, expected {want} and no Swin kernel")
        m = logged[0]
        print(f"[{path}] 1 epoch + eval in {time.perf_counter() - t0:.1f} s; loss "
              f"{m['loss']:.4f} (fg {m['fg_rois']:.0f} / bg {m['bg_rois']:.0f}); AP@25 "
              f"{report['ap_25']['ap']:.4f}, accuracy {report['classification']['accuracy']:.4f}",
              flush=True)
        launches = got if launches is None else {k: launches[k] + v for k, v in got.items()}

    # RoI align alone at 2 x 1024 RoIs: the OBB RoIs and their enclosing boxes
    trainer = run_rpn_detect.Trainer(run_rpn_detect.parse_args(
        ["--mode", "eval", *common_of["obb"], "--num_workers", "0"]))
    host, _ = next(iter(trainer.batches(trainer.dataset(list(scenes["train_scenes"])))))
    b = trainer.device_batch(host)
    rows = {}
    for form in ("obb", "aabb"):
        rotated = form == "obb"
        rois = b["rois"] if rotated else obb2hbb_3d(b["rois"])
        for mode in ("max", "avg"):
            def align(rois=rois, mode=mode, rotated=rotated):
                return multilevel_roi_align_batched(
                    b["features"], rois, b["roi_levels"], b["roi_valid"], SCALES, (3, 3, 3),
                    2, mode, rotated, 0.2)
            ms = time_one(torch, align)
            out = align()
            if not torch.isfinite(out).all():
                fail(f"RoI align {form} {mode}: the output is not finite")
            moved, touched = _roi_align_bytes(torch, b, rois, rotated, out)
            # a value of a bin: 8 samples x 8 corners (multiply, add), then
            # the samples' reduce
            ops = out.numel() * (8 * 8 * 2 + 8)
            rows[f"{form} {mode}"] = {"rois": int(b["roi_valid"].sum()), "ms": ms,
                                      "touched_rows": touched, "bytes": moved,
                                      **bound(moved, ops, "float32")}
    print(f"[rcnn features] RoI align at {tuple(b['rois'].shape[:2])}, f32, 256 channels: "
          + json.dumps(rows), flush=True)
    return launches, rows


def _roi_align_bytes(torch, b, rois, rotated, out):
    """Bytes RoI align must move on these inputs: each feature row that a
    sample's corner touches read once (C f32 values), the RoIs and levels
    read once, the output written once; and the number of those rows."""
    from nerf_rpn_tpu_torch.ops import roi_align as ra

    feats = b["features"]
    bs, r = rois.shape[:2]
    dims = [f.shape[1:4] for f in feats]
    sizes = [d[0] * d[1] * d[2] for d in dims]
    offsets = [sum(s * bs for s in sizes[:i]) for i in range(len(sizes))]
    obb = ra._as_obb(rois.reshape(bs * r, -1).float(), rotated, 0.2)
    lvl = b["roi_levels"].reshape(-1).clamp(0, len(feats) - 1).long()
    scale = torch.tensor(SCALES, dtype=torch.float32, device=obb.device)[lvl]
    obb = torch.cat([obb[:, :6] / scale[:, None], obb[:, 6:]], -1)
    pts = ra.roi_sample_points(obb, (3, 3, 3), 2)
    rows = []
    scene = torch.arange(bs, device=obb.device).repeat_interleave(r)
    for li, (d, off, size) in enumerate(zip(dims, offsets, sizes)):
        sel = lvl == li
        if not sel.any():
            continue
        base = off + scene[sel] * size
        for xi, yi, zi, _ in ra._corners(pts[sel], *d):
            rows.append((base.reshape(-1, *(1,) * 4) + (xi * d[1] + yi) * d[2] + zi).reshape(-1))
    touched = int(torch.unique(torch.cat(rows)).numel())
    c = feats[0].shape[-1]
    moved = touched * c * feats[0].element_size() + nbytes(rois, b["roi_levels"], out)
    return moved, touched


# ---------------------------------------------------------------------------
# Data parallel (parallel/ddp.py)
# ---------------------------------------------------------------------------

# Phase 25's steps at full width, f32 with TF32 off, a global batch of 2:
# ``train.sh``'s Swin-S OBB RPN, the ``resnet`` RPN (BatchNorm) and
# ``train_fcos.sh``'s Swin-S OBB FCOS at 160^3, ``train_rcnn.sh``'s Swin-S
# OBB fine-tune at 200x200x136 (128 RoIs a scene of 512); and the
# ``resnet`` RPN in f64, where flax's E[x^2] - E[x]^2 leaves the f32
# BatchNorm gradients to rounding (phase 18)
DDP_CASES = {
    "swin_s rpn obb": {"head": "rpn", "backbone": "swin_s", "shape": (160, 160, 160)},
    "resnet rpn": {"head": "rpn", "backbone": "resnet", "shape": (160, 160, 160)},
    "resnet rpn f64": {"head": "rpn", "backbone": "resnet", "shape": (160, 160, 160),
                       "dtype": "float64"},
    "swin_s fcos obb": {"head": "fcos", "backbone": "swin_s", "shape": (160, 160, 160)},
    "swin_s rcnn obb": {"head": "rcnn", "backbone": "swin_s", "shape": (200, 200, 136)},
}
DDP_LR = 1e-3
# the step whose gradient all-reduce is timed
DDP_TIMED = "swin_s rpn obb"
# Two ranks of one scene against one process of both, each reading
# relative as in phase 18 (a loss term or norm to the one process's value,
# a running statistic to its leaf's largest entry), and the share of the
# parameters whose AdamW step differs from the one process's by more than
# the first step, lr / 25 (a sign flipped: AdamW's first step is +-lr / 25
# where the gradient is clear of its eps).  The f32 limits sit 3-8x over
# the card's readings (PERF.md, PR 15), which the ``resnet`` step sets:
# its f32 BatchNorm gradients are rounding where a channel's mean dwarfs
# its spread, and its f64 step reads 1e-15 (the f64 limits: 1e-12)
DDP_LIMITS = {
    "float32": {"loss_terms": 1e-5, "grad_norm": 1.5e-2, "param_norm": 1e-6,
                "step_flips": 1e-2, "running_stats": 1e-5},
    "float64": {"loss_terms": 1e-12, "grad_norm": 1e-12, "param_norm": 1e-12,
                "step_flips": 1e-7, "running_stats": 1e-12},
}


def _ddp_case(torch, name, dev):
    """Phase 25's step ``name``: ``(model, batch, sample, run)``, the same
    in every process on ``dev`` -- weights drawn from a seeded generator on
    ``dev``, two unlike scenes, the anchor or RoI sample of both scenes
    (None: FCOS), ``run(model, state, batch, sample) -> metrics``;
    drop-path off."""
    import numpy as np

    from nerf_rpn_tpu_torch.models import detector as det
    from nerf_rpn_tpu_torch.models import rpn as rpn_lib
    from nerf_rpn_tpu_torch.models.fcos import FCOSConfig
    from nerf_rpn_tpu_torch.models.nerf_rpn import (FCOSOverNeRF, NeRFRPN, build_backbone,
                                                    init_params)
    from nerf_rpn_tpu_torch.models.swin import SwinBlock
    from nerf_rpn_tpu_torch.train.steps import (level_shapes_for, make_fcos_train_step,
                                                   make_rcnn_train_step, make_rpn_train_step)

    spec = DDP_CASES[name]
    shape, backbone = spec["shape"], spec["backbone"]
    dtype = getattr(torch, spec.get("dtype", "float32"))
    rng = np.random.default_rng(25)
    grids = rng.uniform(0, 1, (2, *shape, 4)).astype(np.float32)
    ramp = np.linspace(0, 1, shape[0], dtype=np.float32)[:, None, None, None]
    grids[1] = 0.1 * grids[1] + 3.0 * ramp ** 2
    # OBBs of a 160^3 scene, scaled to the grid
    obb = np.array([[[40, 40, 55, 50, 35, 60, 0.4], [110, 115, 70, 45, 60, 50, -1.1],
                     [40, 125, 125, 30, 45, 45, 1.3]],
                    [[50, 40, 30, 90, 70, 50, -0.2], [70, 80, 95, 35, 45, 40, 0.8],
                     [0, 0, 0, 0, 0, 0, 0]]], np.float32)
    obb[..., :6] *= shape[0] / 160
    if spec["head"] == "rcnn":
        rois, levels = _random_rois(np, rng, 2, 512, shape, True,
                                    size=(shape[0] / 10, shape[0] * 0.3))
        batch = _ddp_batch(torch, dev, dtype, grids=grids, rois=rois, roi_levels=levels,
                           roi_valid=np.ones((2, 512), bool), gt_boxes=rois[:, :3],
                           gt_mask=np.ones((2, 3), bool))
        cfg = det.RCNNConfig(rotated=True, batch_size=256, fg_threshold=0.25,
                             bg_threshold=0.25, output_size=(3, 3, 3), pool_mode="max")
        model = det.RCNNDetector(det.RCNNHead(256, 2, True, True, True, (3, 3, 3)),
                                 build_backbone(backbone, shape[0]))
        sample = det.sample_rois(cfg, torch.Generator(dev).manual_seed(0), batch["rois"],
                                 batch["roi_levels"], batch["roi_valid"], batch["gt_boxes"],
                                 batch["gt_mask"], 128)["indices"]

        def run(model, state, batch, sample):
            step = make_rcnn_train_step(model, cfg, SCALES, 128, reg_loss_weight=5.0)
            return step(state, batch, None, indices=sample)
    else:
        rotated = backbone.startswith("swin")
        gt = obb if rotated else np.concatenate(
            [obb[..., :3] - obb[..., 3:6] / 2, obb[..., :3] + obb[..., 3:6] / 2], -1)
        batch = _ddp_batch(torch, dev, dtype, grids=grids, gt_boxes=gt, gt_mask=obb[..., 3] > 0,
                           ori_sizes=np.array([shape, shape], np.int32))
        if spec["head"] == "fcos":
            cfg = FCOSConfig(rotated=True, center_sampling_radius=1.5, iou_loss_type="iou",
                             norm_reg_targets=True)
            model = FCOSOverNeRF(backbone, rotated=True, resolution=shape[0])
            sample = None

            def run(model, state, batch, sample):
                step = make_fcos_train_step(model, cfg, shape, device=dev)
                return step(state, batch, torch.Generator(dev).manual_seed(1))
        else:
            cfg = rpn_lib.RPNConfig(rotated=rotated, reg_loss_weight=5.0)
            model = NeRFRPN(backbone, rotated=rotated, resolution=shape[0], dtype=dtype)
            shapes = level_shapes_for(shape, SCALES)
            anchors, _, strides, _ = rpn_lib.build_level_tables(cfg, shape, shapes)
            pad = rpn_lib.dynamic_padding_masks(shapes, strides, 13, batch["ori_sizes"])
            matches = rpn_lib.assign_anchors(cfg, torch.from_numpy(anchors).to(dev),
                                             batch["gt_boxes"], batch["gt_mask"], pad)
            sample = list(rpn_lib.sample_anchors(cfg, matches,
                                                 torch.Generator(dev).manual_seed(0)))

            def run(model, state, batch, sample):
                step = make_rpn_train_step(model, cfg, shape, SCALES, device=dev)
                return step(state, batch, torch.Generator(dev).manual_seed(0),
                            torch.Generator(dev).manual_seed(1), indices=sample)
    model.to(dev)
    init_params(model, torch.Generator(dev).manual_seed(25))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SwinBlock):
                m.drop_path = 0.0
        for n, t in model.named_buffers():
            if "running_" in n:  # statistics that are not 0 / 1
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
    return model.to(dtype), batch, sample, run


def _ddp_batch(torch, dev, dtype, **arrays):
    """Host arrays -> tensors on ``dev``, the float ones in ``dtype``."""
    return {k: torch.from_numpy(np_array).to(dev, dtype) if np_array.dtype.kind == "f"
            else torch.from_numpy(np_array).to(dev) for k, np_array in arrays.items()}


def _ddp_scene(x, r):
    """Rank r's scene of a batch or a sample."""
    if isinstance(x, dict):
        return {k: v[r:r + 1] for k, v in x.items()}
    if isinstance(x, list):
        return [t[r:r + 1] for t in x]
    return None if x is None else x[r:r + 1]


def _ddp_step(torch, model, run, batch, sample):
    """One train step at ``DDP_LR``: its metrics and the weights after it
    (CPU copies)."""
    from nerf_rpn_tpu_torch.train.state import TrainState

    state = TrainState(model, DDP_LR, 10)
    metrics = run(model, state, batch, sample)
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()})


def _ddp_rank(work, dev):
    """A rank of phase 25 (a): every case on its scene, after rank 1's
    weights were shifted and ``broadcast_module_`` gave it rank 0's back.
    Writes ``ddp_rank<r>.pt``: the metrics, rank 0's weights after the
    step, whether the ranks' weights are bit-equal (rank 0's broadcast
    and compared), K1 and K2 launches, peak GiB and, for the Swin-S RPN,
    the gradient all-reduce's ms."""
    import torch
    import torch.distributed as dist

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.parallel import ddp

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    r, out = ddp.rank(), {}
    for name in DDP_CASES:
        model, batch, sample, run = _ddp_case(torch, name, dev)
        want = [t.clone() for t in model.state_dict().values()]
        if r:
            with torch.no_grad():
                for t in (*model.parameters(), *model.buffers()):
                    t.add_(1)
        ddp.broadcast_module_(model)
        broadcast = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), want))
        del want
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        metrics, state = _ddp_step(torch, model, run, _ddp_scene(batch, r),
                                   _ddp_scene(sample, r))
        torch.cuda.synchronize()
        entry = {"metrics": metrics, "broadcast_equal": broadcast,
                 "launches": {k: kernels.counts()[k]
                              for k in ("window_attention_fwd", "window_attention_bwd")},
                 "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        flat = torch.cat([t.reshape(-1).double() for t in model.state_dict().values()])
        ref = flat.clone()
        dist.broadcast(ref, 0)
        entry["ranks_equal"] = bool(torch.equal(flat, ref))
        del flat, ref
        if name == DDP_TIMED:
            grads = [torch.ones_like(p) for p in model.parameters()]
            ddp.all_reduce_grads_(grads)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                ddp.all_reduce_grads_(grads)
            torch.cuda.synchronize()
            entry["grad_all_reduce_ms"] = (time.perf_counter() - t0) * 1e3 / 3
            entry["grad_mib"] = sum(g.numel() * g.element_size() for g in grads) / 2 ** 20
            del grads
        if r == 0:
            entry["state"] = state
        out[name] = entry
        del model, batch, sample, state
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(work, f"ddp_rank{r}.pt"))


def check_ddp_steps(torch, dev, work, card=""):
    """Phase 25 (a): each of ``DDP_CASES`` in one process at batch 2 (the
    reference, kept on the host, the card freed after each), then on two
    ranks of one scene each on the same card (``ddp.launch``, gloo, which
    carries CUDA tensors; NCCL refuses two ranks on one device).  Every
    rank must hold rank 0's weights after the broadcast and after the step
    bit for bit, log the same metrics, launch K1 and K2 24 times a Swin
    step (0 a ResNet step), and read within ``DDP_LIMITS`` of the
    reference.  Returns the Swin-S RPN's gradient all-reduce ms, printed
    after ``card`` (the ``nvidia-smi`` name and power limit)."""
    import numpy as np

    from nerf_rpn_tpu_torch.models.swin import SWIN_VARIANTS
    from nerf_rpn_tpu_torch.parallel import ddp

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    refs = {}
    for name in DDP_CASES:
        model, batch, sample, run = _ddp_case(torch, name, dev)
        torch.cuda.reset_peak_memory_stats()
        metrics, state = _ddp_step(torch, model, run, batch, sample)
        params = {n for n, _ in model.named_parameters()}
        refs[name] = (metrics, state, params, torch.cuda.max_memory_allocated() / 2 ** 30)
        del model, batch, sample
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ddp.launch(_ddp_rank, (work, dev), [dev, dev], "gloo")
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"ddp_rank{r}.pt"), weights_only=False)
             for r in (0, 1)]
    lr0 = DDP_LR / 25.0
    over = []
    for name, (metrics, state, params, peak) in refs.items():
        r0, r1 = ranks[0][name], ranks[1][name]
        if not (r0["broadcast_equal"] and r1["broadcast_equal"]):
            fail(f"data parallel {name}: broadcast_module_ left the ranks' weights unequal")
        if not (r0["ranks_equal"] and r1["ranks_equal"] and r0["metrics"] == r1["metrics"]):
            fail(f"data parallel {name}: the ranks differ after the step")
        blocks = sum(SWIN_VARIANTS.get(DDP_CASES[name]["backbone"], {"depths": ()})["depths"])
        for rank in (r0, r1):
            want = {"window_attention_fwd": blocks, "window_attention_bwd": blocks}
            if rank["launches"] != want:
                fail(f"data parallel {name}: launches {rank['launches']}, expected {want}")
        got = r0["metrics"]
        if set(got) != set(metrics):
            fail(f"data parallel {name}: metrics {sorted(got)} vs {sorted(metrics)}")
        terms = [k for k in metrics if k.startswith("loss")]
        counts = [k for k in metrics if k.endswith("_rois") or k == "dropped_positives"]
        if any(got[k] != metrics[k] for k in counts):
            fail(f"data parallel {name}: counts {[(got[k], metrics[k]) for k in counts]}")
        # (a term that is 0, the 2D term at weight 0, must stay 0)
        rel = {k: abs(got[k] - metrics[k]) / (abs(metrics[k]) or 1.0) for k in metrics
               if k not in counts}
        read = {"loss_terms": max(rel[k] for k in terms), "grad_norm": rel["grad_norm"],
                "param_norm": rel["param_norm"], "step_flips": 0.0, "running_stats": 0.0}
        flips = entries = 0
        for k, want in state.items():
            diff = (r0["state"][k].double() - want.double()).abs()
            if "running_" in k:
                read["running_stats"] = max(read["running_stats"],
                                            diff.max().item() / want.abs().max().item())
            elif k in params:
                flips += int((diff > lr0).sum())
                entries += diff.numel()
        read["step_flips"] = flips / entries
        limits = DDP_LIMITS[DDP_CASES[name].get("dtype", "float32")]
        row = {"case": name, "readings": read, "limits": limits, "flipped_steps": flips,
               "loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
               "one_process_peak_gib": peak, "rank_peak_gib": [r0["peak_gib"], r1["peak_gib"]],
               "launches_per_rank": r0["launches"],
               **{k: got[k] for k in counts}}
        print("[data parallel step]", json.dumps(row), flush=True)
        over += [f"{name}: {k} {v} over its limit {limits[k]}" for k, v in read.items()
                 if not (np.isfinite(v) and v <= limits[k])]
    # an f32 step against its f64 twin (the same weights and scenes): the
    # one process's and the two ranks' distance from it, by the readings
    for name in (n for n in refs if n + " f64" in refs):
        truth, state64 = refs[name + " f64"][:2]
        for who, (m, st) in (("one process", refs[name][:2]),
                             ("two ranks", (ranks[0][name]["metrics"],
                                            ranks[0][name]["state"]))):
            diffs = [(st[k].double() - v).abs() for k, v in state64.items()
                     if k in refs[name][2]]
            print(f"[data parallel] {name} in f32 against f64, {who}: grad_norm "
                  f"{abs(m['grad_norm'] - truth['grad_norm']) / truth['grad_norm']:.3g}, "
                  f"loss {abs(m['loss'] - truth['loss']) / truth['loss']:.3g}, step flips "
                  f"{sum(int((d > lr0).sum()) for d in diffs) / sum(d.numel() for d in diffs):.3g}",
                  flush=True)
    if over:  # after every case's readings are printed
        fail("data parallel: " + "; ".join(over))
    timed = [rank[DDP_TIMED] for rank in ranks]
    print(f"[data parallel] {card}: 2 ranks on one card over gloo: {ranks_s:.1f} s for "
          f"{len(refs)} steps a rank; the Swin-S RPN's gradient all-reduce "
          f"({timed[0]['grad_mib']:.1f} MiB f32) {timed[0]['grad_all_reduce_ms']:.2f} ms on "
          f"rank 0, {timed[1]['grad_all_reduce_ms']:.2f} ms on rank 1", flush=True)
    return timed[0]["grad_all_reduce_ms"]


def run_ddp_driver_paths(torch, work, rpn_train_launches, rcnn_common):
    """Phase 25 (b): the drivers with ``--gpus 0`` (NCCL, a group of one in
    this process): ``run_rpn``'s train path (phase 10's, ``--mode train``
    then ``--mode eval --checkpoint <save>/model_best``), whose launches
    must equal phase 10's; ``run_fcos`` on the OBB scenes with
    ``train_fcos.sh``'s flags and ``run_rpn_detect`` with
    ``train_rcnn.sh``'s on phase 23's, one epoch of two steps and the
    validation eval each, ``model_best`` written."""
    import numpy as np

    from nerf_rpn_tpu_torch import kernels
    from nerf_rpn_tpu_torch.cli import run_fcos, run_rpn_detect

    gpus = ["--gpus", "0"]
    paths = {}
    paths["train --gpus 0"], data, common = run_train_path(torch, work, extra=gpus)
    if paths["train --gpus 0"] != rpn_train_launches:
        fail(f"run_rpn --gpus 0: launches {paths['train --gpus 0']}, phase 10's "
             f"{rpn_train_launches}")
    _, fcos_common = write_train_data(work, rotated=True)
    for path, cli, argv in (
            ("fcos obb train --gpus 0", run_fcos, [*fcos_common, *FCOS_TRAIN_FLAGS]),
            ("rcnn train --gpus 0", run_rpn_detect, rcnn_common)):
        save = os.path.join(work, path.replace(" ", "_").replace("-", ""))
        kernels.reset_counts()
        logged = cli.main(["--mode", "train", *argv, "--num_epochs", "1", "--log_interval",
                           "1", "--save_path", save, *gpus])
        torch.cuda.synchronize()
        launches = kernels.counts()
        if len(logged) != 2 or not all(np.isfinite(m["loss"]) for m in logged):
            fail(f"{path}: logged {logged}")
        if not os.path.isfile(os.path.join(save, "model_best")):
            fail(f"{path}: rank 0 wrote no model_best")
        if cli is run_fcos:
            require_launches(launches, OBB_TRAIN_KERNELS, path,
                             absent=("aabb_suppression_graph",))
            if launches["window_attention_bwd"] != 48:
                fail(f"{path}: K2 launched {launches['window_attention_bwd']} times in 2 steps")
        else:
            _rcnn_launch_check(launches, path, steps=2, eval_batches=1, eval_scenes=2)
        print(f"[{path}] losses " + ", ".join(f"{m['loss']:.4f}" for m in logged), flush=True)
        paths[path] = launches
    return paths, data, common


def time_gpus_flag(torch, data, common, steps=10, card=""):
    """Phase 25 (c): the RPN train step (Swin-S bf16, 160^3, batch 2) in a
    group of one, as ``--gpus 0`` runs it, and alone, in turns alone,
    group, group, alone: mean device ms a step (CUDA events), printed after
    ``card``."""
    import numpy as np

    from nerf_rpn_tpu_torch.cli import run_rpn
    from nerf_rpn_tpu_torch.data.datasets import batch_iterator
    from nerf_rpn_tpu_torch.parallel import ddp
    from nerf_rpn_tpu_torch.train.state import TrainState
    from nerf_rpn_tpu_torch.train.steps import make_rpn_train_step

    args = run_rpn.parse_args(["--mode", "train", *common, "--num_workers", "0",
                               "--save_path", os.path.join(os.path.dirname(data), "timed")])
    trainer = run_rpn.Trainer(args)
    train_set, _, _ = run_rpn.common.build_datasets(args, "train", augment=False)
    host = next(iter(batch_iterator(train_set, 2, fixed_shape=trainer.mesh_shape,
                                    box_dim=6, num_workers=0)))
    batch = run_rpn.common.device_batch(host, trainer.device, trainer.dtype)
    state = TrainState(trainer.model, args.lr, 4 * steps + 4)
    step = make_rpn_train_step(trainer.model, trainer.cfg_train, trainer.mesh_shape,
                               run_rpn.STRIDES, device=trainer.device)
    gen = torch.Generator(trainer.device).manual_seed(0)
    drop = torch.Generator(trainer.device).manual_seed(1)

    def timed():
        step(state, batch, gen, drop)
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(steps)]
        for a, b in events:
            a.record()
            step(state, batch, gen, drop)
            b.record()
        torch.cuda.synchronize()
        return float(np.mean([a.elapsed_time(b) for a, b in events]))

    ms = {"alone": [], "gpus 0": []}
    for kind in ("alone", "gpus 0", "gpus 0", "alone"):
        ms[kind].append(timed() if kind == "alone" else
                        ddp.launch(timed, (), [trainer.device], "nccl"))
    print(f"[data parallel] {card}: RPN train step (Swin-S bf16, 160^3, batch 2), mean of "
          f"{steps}: alone {ms['alone']} ms, --gpus 0 (a group of one, NCCL) {ms['gpus 0']} "
          "ms", flush=True)
    return ms


# The gate's seeds, and on how many of them the JAX package's own gate
# clears each combo (``scripts/synthetic_quality_gate.py --combos <combo>
# --seed <s>`` on the CPU; PERF.md, PR 13).  One seed cannot decide: over
# these seeds the recipe's AP@50 spreads over 0.40-0.99 (rpn_aabb) and
# 0.06-0.82 (fcos_obb) in the JAX package itself (its ``model_best`` is the
# first epoch at the best validation Recall@50 of four scenes, and AP is
# taken over eight).
GATE_SEEDS = (0, 1, 2, 3, 4, 5)
JAX_GATE_PASSES = {"rpn_aabb": 2, "fcos_obb": 1, "rcnn": 3}


def run_quality_gate(torch, workdir, combos=("rpn_aabb", "fcos_obb", "rcnn")):
    """The port's train-to-quality gate on the card (``cli/quality_gate.py``
    through ``run_rpn`` / ``run_fcos``, resnet_tiny, f32, 60 epochs at
    32^3), under torch's deterministic algorithms as the gate's CLI runs
    on the card (one seed, one result): AP@25, AP@50, Recall@25, the
    validation Recall@50 curve and the seconds of each run.  Seeds run in
    ``GATE_SEEDS``' order until a combo has cleared its gates (the
    script's thresholds) as many times as the JAX package's gate does on
    those seeds (``JAX_GATE_PASSES``), and at least once; the phase fails
    if it does not.  The combos run at once, a process each on the card
    (host-bound runs; each seed's result is the one it gives alone)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(len(combos), mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {combo: pool.submit(_gate_combo, combo, workdir) for combo in combos}
        rows = {combo: f.result() for combo, f in futures.items()}
    for combo, combo_rows in rows.items():
        need = max(1, JAX_GATE_PASSES[combo])
        if sum(r["pass"] for r in combo_rows) < need:
            fail(f"quality gate: {combo} cleared its gates at "
                 f"{sum(r['pass'] for r in combo_rows)} of seeds {GATE_SEEDS}, not "
                 f"{need} (the JAX package's gate: {JAX_GATE_PASSES[combo]})")
    return rows


def _gate_combo(combo, workdir):
    """One combo's gate runs, in a process of its own: seeds in order until
    it has cleared its gates ``JAX_GATE_PASSES`` times (and at least once)."""
    import torch

    from nerf_rpn_tpu_torch.cli import quality_gate

    torch.set_num_threads(2)
    quality_gate.use_deterministic_algorithms()
    need, rows = max(1, JAX_GATE_PASSES[combo]), []
    for seed in GATE_SEEDS:
        rows.append(_gate_row(quality_gate, combo, seed, workdir))
        if sum(r["pass"] for r in rows) >= need:
            break
    return rows


def _gate_row(quality_gate, combo, seed, workdir):
    t0 = time.perf_counter()
    ap25, ap50, aux, _, curve = quality_gate.run_combo(
        combo, os.path.join(workdir, f"gate_seed{seed}"), device="cuda", seed=seed)
    row = {"combo": combo, "seed": seed, "ap25": ap25, "ap50": ap50,
           "cls_accuracy" if combo == "rcnn" else "recall25": aux,
           "gate_ap25": quality_gate.GATES[combo], "gate_ap50": quality_gate.GATES_AP50[combo],
           "val_recall50_curve": curve, "seconds": time.perf_counter() - t0}
    row["pass"] = quality_gate.passes(combo, ap25, ap50, aux)
    print("[quality gate]", json.dumps(row), flush=True)
    return row


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    try:
        from nerf_rpn_tpu_torch import kernels
    except ImportError as e:
        fail(f"run from the repository root: cannot import the port ({e})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    print(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as cubins:
        reports = [(lib, start_ptxas_report(kernels, lib, cubins))
                   for lib in ("window_attention", "window_attention_bwd", "nms_graph",
                               "fused_ln_qkv", "fused_mlp")]
        build_s = kernels.build_all()
        for lib, proc in reports:
            print_ptxas_report(proc, lib)
    print(f"[build] kernels built and loaded in {build_s:.2f} s", flush=True)
    phase_done(torch, "build", t0)

    t0 = time.perf_counter()
    _, k1 = check_window_attention(torch, dev)
    phase_done(torch, "K1 vs twin", t0)

    t0 = time.perf_counter()
    _, k2 = check_window_attention_backward(torch, dev)
    phase_done(torch, "K2 vs twin", t0)

    t0 = time.perf_counter()
    k3 = check_suppression_graph(torch, dev)
    resolve = check_nms_resolve(torch, dev)
    phase_done(torch, "K3 and resolve vs twins", t0)

    t0 = time.perf_counter()
    _, k4 = check_fused_window_attention(torch, dev)
    phase_done(torch, "K4 vs twin", t0)

    t0 = time.perf_counter()
    _, k5 = check_ln_partition_qkv(torch, dev)
    phase_done(torch, "K5 vs twin", t0)

    t0 = time.perf_counter()
    _, k6 = check_fused_mlp(torch, dev)
    phase_done(torch, "K6 vs twin", t0)

    t0 = time.perf_counter()
    check_small_slice(torch, dev)
    phase_done(torch, "small slice vs CPU", t0)

    t0 = time.perf_counter()
    check_small_train_step(torch, dev)
    phase_done(torch, "small train step vs CPU", t0)

    t0 = time.perf_counter()
    check_obb_nms(torch)
    phase_done(torch, "OBB NMS vs CPU", t0)

    # each path runs with the counts set to 0 just before it
    paths = {}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        paths["eval"], _ = run_eval_path(torch, work)
        phase_done(torch, "eval path", t0)

        t0 = time.perf_counter()
        paths["train"], data, common = run_train_path(torch, work)
        phase_done(torch, "train path", t0)

        t0 = time.perf_counter()
        time_train_steps(torch, data, common)
        phase_done(torch, "timed train steps", t0)

        t0 = time.perf_counter()
        paths["obb eval"], _ = run_obb_benchmark(torch)
        phase_done(torch, "OBB eval path", t0)

        t0 = time.perf_counter()
        paths["obb train"], data, common = run_train_path(torch, work, rotated=True)
        phase_done(torch, "OBB train path", t0)

        t0 = time.perf_counter()
        time_train_steps(torch, data, common)
        phase_done(torch, "timed OBB train steps", t0)

        t0 = time.perf_counter()
        check_fcos_nms(torch)
        phase_done(torch, "FCOS NMS vs CPU", t0)

        t0 = time.perf_counter()
        paths["fcos obb eval"], _ = run_fcos_benchmark(torch, rotated=True)
        paths["fcos aabb eval"], _ = run_fcos_benchmark(torch, rotated=False)
        phase_done(torch, "FCOS eval path", t0)

        t0 = time.perf_counter()
        paths["fcos obb train"], data, common = run_train_path(torch, work, rotated=True,
                                                               fcos=True)
        phase_done(torch, "FCOS train path", t0)

        t0 = time.perf_counter()
        time_train_steps(torch, data, common, fcos=True)
        phase_done(torch, "timed FCOS train steps", t0)

        t0 = time.perf_counter()
        check_cnn_small_slice(torch, dev)
        phase_done(torch, "ResNet / VGG small slice and train step vs CPU", t0)

        t0 = time.perf_counter()
        paths["cnn eval"], _ = run_cnn_benchmarks(torch)
        phase_done(torch, "ResNet / VGG eval paths", t0)

        t0 = time.perf_counter()
        paths["resnet train"], data, common = run_cnn_train_path(torch, work)
        time_train_steps(torch, data, common)
        phase_done(torch, "ResNet train path and timed train steps", t0)

        t0 = time.perf_counter()
        run_quality_gate(torch, work)
        phase_done(torch, "quality gate", t0)

        t0 = time.perf_counter()
        check_rcnn_small_slice(torch, dev)
        phase_done(torch, "RCNN small slice and train step vs CPU", t0)

        t0 = time.perf_counter()
        paths["rcnn fine-tune"], data, results, rcnn_common = run_rcnn_path(
            torch, work, os.path.join(work, "obb_train", "model_best"))
        time_rcnn_steps(torch, rcnn_common)
        phase_done(torch, "RCNN fine-tune path (train_rcnn.sh) and timed steps", t0)

        t0 = time.perf_counter()
        paths["rcnn features"], _ = run_rcnn_features_path(torch, work, data, results)
        phase_done(torch, "RCNN features path and RoI align", t0)

        t0 = time.perf_counter()
        check_ddp_steps(torch, dev, work, smi)
        ddp_paths, data, common = run_ddp_driver_paths(torch, work, paths["train"],
                                                       rcnn_common)
        paths.update(ddp_paths)
        time_gpus_flag(torch, data, common, card=smi)
        phase_done(torch, "data parallel", t0)

    print("[launches by path]", json.dumps(paths), flush=True)
    entries = [
        ("window_attention_fwd", "window_attention.cu", "window_attention.py:80", k1),
        ("window_attention_bwd", "window_attention_bwd.cu", "window_attention.py:313", k2),
        ("aabb_suppression_graph", "nms_graph.cu", "nms_graph.py:47", k3),
        # not a Pallas kernel: the lax.while_loop fixpoint over K3's graph
        ("nms_resolve", "nms_graph.cu", "nms.py:258", resolve),
        ("fused_window_attention", "window_attention.cu", "window_attention.py:208", k4),
        ("ln_partition_qkv", "fused_ln_qkv.cu", "fused_ln_qkv.py:81", k5),
        ("fused_mlp_block", "fused_mlp.cu", "fused_mlp.py:62", k6),
    ]
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": f"nerf_rpn_tpu_torch/csrc/{src}",
         "replaces": f"nerf_rpn_tpu/ops/{tpu}",
         "launches": sum(counts[name] for counts in paths.values()),
         **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}}
        for name, src, tpu, row in entries]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
