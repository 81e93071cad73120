"""The torch port imports neither jax nor the JAX package ``nerf_rpn_tpu``.

A subprocess blocks jax / jaxlib / flax / optax / orbax and ``nerf_rpn_tpu``
with a meta-path hook, imports every module of ``nerf_rpn_tpu_torch``,
writes synthetic 32^3 datasets with the port's own writer and runs the CPU
slice end to end through the CLI -- ``run_rpn --mode train`` for one epoch,
then ``--mode eval --checkpoint model_best``, with AABBs and then with OBBs
(``--rotated_bbox``, the 2D projection loss on), then ``run_fcos --mode
train`` and ``--mode eval --checkpoint model_best`` on the OBB scenes
(``train_fcos.sh``'s loss flags), then with ``resnet_tiny``: ``run_rpn
--check_arch``, ``--mode train`` and ``--mode eval --save_results
--output_all`` (the RCNN stage's files checked against the JAX driver's
layout), ``run_fcos --load_backbone_only --output_all --conv_at_start``
from that checkpoint, ``run_rpn_detect --fine_tune`` for one epoch from
it (``--pretrained``) and its eval, and one epoch of the quality gate --
and checks that
none of them reached ``sys.modules``.  An AST scan shows that no file of the port,
and not ``chip_smoke.py``, names them in an import statement.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "nerf_rpn_tpu")

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "nerf_rpn_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in the torch port")
        return None

sys.meta_path.insert(0, Block())

import nerf_rpn_tpu_torch
for mod in pkgutil.walk_packages(nerf_rpn_tpu_torch.__path__, "nerf_rpn_tpu_torch."):
    importlib.import_module(mod.name)

from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_dataset
from nerf_rpn_tpu_torch.cli import run_rpn

import os
for data, extra in ((sys.argv[1], []),
                    (sys.argv[1] + "/obb", ["--rotated_bbox", "--reg_loss_weight_2d", "0.5"])):
    write_synthetic_dataset(data, n_train=2, n_val=1, n_test=1, resolution=(32, 32, 32),
                            rotated=bool(extra))
    common = ["--backbone_type", "swin_t", "--resolution", "32",
              "--rpn_head_conv_depth", "1", "--rpn_pre_nms_top_n_test", "64",
              "--rpn_post_nms_top_n_test", "32", "--device", "cpu", "--num_workers", "0",
              "--features_path", data, "--boxes_path", data,
              "--dataset_split", data + "/split.npz", *extra]
    logged = run_rpn.main(["--mode", "train", "--num_epochs", "1", "--log_interval", "1",
                           "--save_path", data + "/run", *common])
    assert len(logged) == 2 and all(m["loss"] > 0 for m in logged), logged
    run_rpn.main(["--mode", "eval", "--checkpoint", data + "/run/model_best",
                  "--save_path", data + "/out", "--output_proposals", *common])
    assert os.path.exists(data + "/out/eval.json")
    import numpy as np
    with np.load(data + "/out/proposals/synth003.npz") as z:
        assert z["proposal"].shape[1] == (7 if extra else 6), z["proposal"].shape

from nerf_rpn_tpu_torch.cli import run_fcos
data = sys.argv[1] + "/obb"
common = ["--backbone_type", "swin_t", "--resolution", "32", "--num_convs", "1",
          "--rotated_bbox", "--norm_reg_targets", "--centerness_on_reg",
          "--iou_loss_type", "iou", "--pre_nms_top_n", "64", "--fpn_post_nms_top_n", "32",
          "--device", "cpu", "--num_workers", "0", "--features_path", data,
          "--boxes_path", data, "--dataset_split", data + "/split.npz"]
logged = run_fcos.main(["--mode", "train", "--num_epochs", "1", "--log_interval", "1",
                        "--save_path", data + "/fcos", *common])
assert len(logged) == 2 and all(m["loss"] > 0 for m in logged), logged
run_fcos.main(["--mode", "eval", "--checkpoint", data + "/fcos/model_best",
               "--save_path", data + "/fcos_out", "--output_proposals", "--save_level_index",
               *common])
with np.load(data + "/fcos_out/proposals/synth003.npz") as z:
    assert z["proposal"].shape[1] == 7 and "level_indices" in z.files
# the CNN backbones (BatchNorm statistics in the checkpoint), the drivers'
# other flags and the quality gate
data = sys.argv[1]
common = ["--backbone_type", "resnet_tiny", "--resolution", "32", "--rpn_head_conv_depth", "1",
          "--rpn_pre_nms_top_n_test", "64", "--rpn_post_nms_top_n_test", "32", "--device", "cpu",
          "--num_workers", "0", "--features_path", data, "--boxes_path", data,
          "--dataset_split", data + "/split.npz"]
assert run_rpn.main(["--check_arch", *common]) > 0
logged = run_rpn.main(["--mode", "train", "--num_epochs", "1", "--log_interval", "1",
                       "--batch_size", "2", "--save_path", data + "/cnn", *common])
assert len(logged) == 1 and logged[0]["loss"] > 0, logged
import torch
ckpt = torch.load(data + "/cnn/model_best", weights_only=True)
assert int(ckpt["backbone_state_dict"]["bn1.num_batches_tracked"]) == 1
run_rpn.main(["--mode", "eval", "--checkpoint", data + "/cnn/model_best", "--save_path",
              data + "/cnn_out", "--save_results", "--output_all", *common])
scenes = ["synth000", "synth001", "synth002", "synth003"]
for sub in ("features", "proposals"):
    assert sorted(os.listdir(f"{data}/cnn_out/results/{sub}")) == [s + ".npz" for s in scenes]
with np.load(data + "/cnn_out/results/features/synth003.npz", allow_pickle=True) as z:
    assert sorted(z.files) == ["level_features", "resolution"]
    lf, res = z["level_features"], z["resolution"]
    assert lf.dtype == object and lf.shape == (4,)
    assert res.tolist() == [[32, 8, 8, 8], [32, 4, 4, 4], [32, 2, 2, 2], [32, 1, 1, 1]]
    assert all(f.shape == (int(np.prod(r)),) for f, r in zip(lf, res))
with np.load(data + "/cnn_out/results/proposals/synth003.npz") as z:
    assert sorted(z.files) == ["level_indices", "proposals"]
    assert z["proposals"].dtype == np.float32 and z["proposals"].shape[1] == 6
    assert z["level_indices"].dtype == np.int32
    assert z["level_indices"].shape == (z["proposals"].shape[0],)
fc = ["--backbone_type", "resnet_tiny", "--resolution", "32", "--num_convs", "1",
      "--pre_nms_top_n", "64", "--fpn_post_nms_top_n", "32", "--device", "cpu",
      "--num_workers", "0", "--features_path", data, "--boxes_path", data,
      "--dataset_split", data + "/split.npz", "--conv_at_start"]
run_fcos.main(["--mode", "eval", "--checkpoint", data + "/cnn/model_best", "--load_backbone_only",
               "--output_all", "--output_proposals", "--save_path", data + "/cnn_fcos", *fc])
assert sorted(os.listdir(data + "/cnn_fcos/proposals")) == [s + ".npz" for s in scenes]
# the RCNN stage: fine-tuned from the stage-1 checkpoint, then its eval
from nerf_rpn_tpu_torch.cli import run_rpn_detect
from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_rois
write_synthetic_rois(data, data + "/rois")
det = ["--features_path", data, "--boxes_path", data, "--rois_path", data + "/rois",
       "--dataset_split", data + "/split.npz", "--save_path", data + "/rcnn", "--device", "cpu",
       "--num_workers", "0", "--fine_tune", "--backbone_type", "resnet_tiny", "--resolution",
       "32", "--feature_input_dim", "32", "--output_size", "2", "2", "2", "--is_flatten",
       "--max_rois", "24", "--cls_batch_size", "16", "--batch_size", "2"]
logged = run_rpn_detect.main(["--mode", "train", "--num_epochs", "1", "--pretrained",
                              data + "/cnn/model_best", *det])
assert len(logged) == 1 and logged[0]["loss"] > 0, logged
res = run_rpn_detect.main(["--mode", "eval", "--checkpoint", data + "/rcnn/model_best",
                           "--output_proposals", *det])
assert set(res) == {"ap_25", "ap_50", "classification"}, res
assert os.path.exists(data + "/rcnn/proposals/synth003.npz")
from nerf_rpn_tpu_torch.cli import quality_gate
assert quality_gate.main(["--device", "cpu", "--combos", "rpn_aabb", "--num_epochs", "1",
                          "--work_dir", data + "/gate"]) in (0, 1)
import json
with open(data + "/gate/gate_results.json") as f:
    assert set(json.load(f)) == {"rpn_aabb"}
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("JAX_FREE_OK")
"""


def test_port_runs_the_cpu_slice_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "JAX_FREE_OK" in res.stdout


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted(Path(REPO, "nerf_rpn_tpu_torch").rglob("*.py")) + [
        Path(REPO, "chip_smoke.py")]
    assert len(files) > 30
    names = {str(f.relative_to(REPO)) for f in files}
    for new in ("ops/rotated_iou.py", "ops/fcos_box.py", "models/fcos.py",
                "cli/run_fcos.py", "ops/pooling.py", "models/resnet.py", "models/vgg.py",
                "cli/quality_gate.py", "ops/roi_align.py", "models/detector.py",
                "cli/run_rpn_detect.py"):
        assert f"nerf_rpn_tpu_torch/{new}" in names, new
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in BLOCKED]
    assert not bad, bad


def test_run_rpn_without_device_raises_without_a_gpu():
    import torch

    from nerf_rpn_tpu_torch.cli import run_rpn

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    assert run_rpn.parse_args(["--mode", "eval"]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        run_rpn.main(["--mode", "eval", "--backbone_type", "swin_t"])
