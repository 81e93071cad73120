"""Train-to-quality gate on synthetic scenes through the port's drivers.

The port's copy of ``scripts/synthetic_quality_gate.py``: for each (head x
box type) combo it writes a synthetic dataset
(``nerf_rpn_tpu_torch.data.synthetic``), trains the tiny configuration
(``resnet_tiny``, f32) from scratch with ``cli/run_rpn.py`` or
``cli/run_fcos.py``, evaluates ``model_best`` on the held-out test split
with the same driver, and holds AP@25 and AP@50 from its ``eval.json`` to
the gates below (the script's own).  It is the check that catches "the
loss goes down but the detector never localizes".

Combos: ``rpn_aabb``, ``rpn_obb``, ``fcos_aabb``, ``fcos_obb`` (32^3
scenes, 60 epochs, minutes each on the CPU) and ``rpn_aabb_r200``
(200x200x130 scenes padded to 208x208x144, sized for the GPU; opt-in).
The RCNN combo waits for the port's RCNN stage.

Usage::

    python -m nerf_rpn_tpu_torch.cli.quality_gate [--device cuda|cpu] \\
        [--combos rpn_aabb fcos_obb] [--work_dir DIR]

One JSON line per combo (AP@25, AP@50, Recall@25, the validation
Recall@50 curve, seconds); exits 1 when a combo misses its gate.

On the card the gate runs torch's deterministic algorithms, so one seed
gives one result: otherwise the atomics of the backward passes change the
last bits of each step, and sixty epochs turn them into another detector
whose AP@50 spreads as the seeds' do.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time

GATES = {
    "rpn_aabb": 0.9,
    # the anchor OBB formulation's measured ceiling (the reference's own
    # midpoint-offset coder under smooth-L1): the gate sits under it
    "rpn_obb": 0.7,
    "fcos_aabb": 0.9,
    "fcos_obb": 0.8,
    "rpn_aabb_r200": 0.9,
}
GATES_AP50 = {
    "rpn_aabb": 0.8,
    "rpn_obb": 0.5,
    "fcos_aabb": 0.8,
    "fcos_obb": 0.8,
    "rpn_aabb_r200": 0.8,
}


def use_deterministic_algorithms() -> None:
    """Same seed, same result on the card: cuDNN's deterministic
    convolutions and torch's deterministic mode, which raises on an op that
    has no deterministic form.  cuBLAS reads its workspace setting at its
    first call, so ``main`` sets it before torch starts."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)


def _common_data_args(data_dir, device):
    return [
        "--features_path", data_dir,
        "--boxes_path", data_dir,
        "--dataset_split", os.path.join(data_dir, "split.npz"),
        "--resolution", "32",
        "--pad_multiple", "32",
        "--max_gt", "8",
        "--device", device,
    ]


def _train_then_eval(cli, common, train_args, save_path):
    """``--mode train`` then ``--mode eval --checkpoint model_best``;
    returns the eval's ``eval.json``."""
    cli.main(common + ["--mode", "train", *train_args])
    cli.main(common + ["--mode", "eval", "--checkpoint", os.path.join(save_path, "model_best")])
    with open(os.path.join(save_path, "eval.json")) as f:
        return json.load(f)


def _train_args(num_epochs, batch_size, eval_interval, seed):
    return ["--num_epochs", str(num_epochs), "--batch_size", str(batch_size), "--lr", "3e-3",
            "--flip_prob", "0.5", "--rotate_prob", "0.5", "--rot_scale_prob", "0.0",
            "--eval_interval", str(eval_interval), "--log_to_file", "--seed", str(seed)]


def run_rpn_gate(data_dir, save_path, rotated, device, num_epochs=60, seed=0):
    """Train + eval the anchor RPN through ``run_rpn``; returns eval.json."""
    from nerf_rpn_tpu_torch.cli import run_rpn

    common = _common_data_args(data_dir, device) + [
        "--save_path", save_path,
        "--backbone_type", "resnet_tiny",
        "--rpn_head_conv_depth", "2",
        "--rpn_pre_nms_top_n_train", "512",
        "--rpn_post_nms_top_n_train", "256",
        "--rpn_pre_nms_top_n_test", "512",
        "--rpn_post_nms_top_n_test", "256",
    ] + (["--rotated_bbox"] if rotated else [])
    return _train_then_eval(run_rpn, common, _train_args(num_epochs, 4, 5, seed), save_path)


def run_rpn_gate_r200(data_dir, save_path, device, num_epochs=60, seed=0):
    """The bench shape class: the anchor RPN on 200x200x130 scenes padded
    to 208x208x144 (~1.4M anchors through top-k, NMS and the padding
    masks), with the 32^3 combos' recipe (resnet_tiny, f32, lr 3e-3, head
    depth 2) at batch 2."""
    from nerf_rpn_tpu_torch.cli import run_rpn

    common = [
        "--features_path", data_dir,
        "--boxes_path", data_dir,
        "--dataset_split", os.path.join(data_dir, "split.npz"),
        "--resolution", "200",
        "--pad_multiple", "16",
        "--max_gt", "8",
        "--device", device,
        "--save_path", save_path,
        "--backbone_type", "resnet_tiny",
        "--rpn_head_conv_depth", "2",
    ]
    return _train_then_eval(run_rpn, common, _train_args(num_epochs, 2, 10, seed), save_path)


def run_fcos_gate(data_dir, save_path, rotated, device, num_epochs=60, seed=0):
    """Train + eval FCOS through ``run_fcos``; returns eval.json."""
    from nerf_rpn_tpu_torch.cli import run_fcos

    common = _common_data_args(data_dir, device) + [
        "--save_path", save_path,
        "--backbone_type", "resnet_tiny",
        "--num_convs", "2",
        "--norm_reg_targets", "--centerness_on_reg",
        "--pre_nms_top_n", "512",
        "--fpn_post_nms_top_n", "256",
    ] + (["--rotated_bbox"] if rotated else [])
    return _train_then_eval(run_fcos, common, _train_args(num_epochs, 4, 5, seed), save_path)


def parse_recall_curve(log_path):
    """Validation Recall@50 per eval from the driver's log file (one 'Top N:
    Recall@50 x' line per --eval_interval epochs)."""
    curve = []
    if not os.path.isfile(log_path):
        return curve
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Top \d+: Recall@50 ([0-9.]+)", line)
            if m:
                curve.append(float(m.group(1)))
    return curve


def run_combo(combo, work_dir, device="cuda", num_epochs=60, seed=0):
    """Write the data, train, evaluate; returns (AP@25, AP@50, Recall@25,
    eval.json, validation Recall@50 curve)."""
    from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_dataset

    if combo not in GATES:
        raise ValueError(f"unknown combo {combo!r}; the port runs {sorted(GATES)}")
    rotated = combo.endswith("obb")
    data_dir = os.path.join(work_dir, f"data_{combo}")
    save_path = os.path.join(work_dir, f"out_{combo}")
    if combo == "rpn_aabb_r200":
        write_synthetic_dataset(data_dir, n_train=8, n_val=2, n_test=4,
                                resolution=(200, 200, 130), box_size=(24.0, 72.0),
                                max_boxes=4, seed=seed)
        results = run_rpn_gate_r200(data_dir, save_path, device, num_epochs, seed)
    else:
        write_synthetic_dataset(data_dir, rotated=rotated, seed=seed)
        runner = run_rpn_gate if combo.startswith("rpn") else run_fcos_gate
        results = runner(data_dir, save_path, rotated, device, num_epochs, seed)
    r25 = next(v["ar"] for k, v in results.items() if k.startswith("recall_25"))
    log = "run_rpn_torch.log" if combo.startswith("rpn") else "run_fcos_torch.log"
    curve = parse_recall_curve(os.path.join(save_path, log))
    return results["ap_25"]["ap"], results["ap_50"]["ap"], r25, results, curve


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--combos", nargs="+",
                   default=sorted(k for k in GATES if k != "rpn_aabb_r200"),
                   choices=sorted(GATES))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a GPU) | cpu.")
    p.add_argument("--num_epochs", type=int, default=60)
    p.add_argument("--work_dir", default=None, help="Defaults to a fresh temp dir.")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.device == "cuda":
        use_deterministic_algorithms()

    work_dir = args.work_dir or tempfile.mkdtemp(prefix="nerf_rpn_gate_")
    print(f"work dir: {work_dir}", flush=True)
    failures, summary = [], {}
    for combo in args.combos:
        t0 = time.time()
        ap25, ap50, r25, _, curve = run_combo(combo, work_dir, args.device, args.num_epochs,
                                              args.seed)
        ok = ap25 >= GATES[combo] and ap50 >= GATES_AP50[combo]
        summary[combo] = {
            "combo": combo, "device": args.device, "ap25": ap25, "ap50": ap50,
            "recall25": r25, "gate_ap25": GATES[combo], "gate_ap50": GATES_AP50[combo],
            "pass": ok, "val_recall50_curve": curve, "seconds": time.time() - t0,
        }
        print(json.dumps(summary[combo]), flush=True)
        if not ok:
            failures.append(combo)
    with open(os.path.join(work_dir, "gate_results.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if failures:
        print(f"FAILED combos: {failures}", file=sys.stderr)
        return 1
    print("all gates passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
