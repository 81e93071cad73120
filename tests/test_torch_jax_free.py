"""The torch port imports neither jax nor the JAX package ``nerf_rpn_tpu``.

Subprocesses block jax / jaxlib / flax / optax / orbax and ``nerf_rpn_tpu``
with a meta-path hook, run the CPU slice end to end through the CLI on
synthetic 32^3 datasets written with the port's own writer, and check that
none of the blocked packages reached ``sys.modules``.  The slice is three
parts (:data:`PARTS`), each a test in a file of its own so that ``--dist
loadfile`` spreads them over the workers:

- ``rpn`` (here): every module of ``nerf_rpn_tpu_torch`` imported (the
  native loader, ``datatools`` and ``utils/debug``, ``utils/profiling``
  among them), ``python -m nerf_rpn_tpu_torch.datatools.scannet_boxes
  --help``, ``run_rpn --mode train`` for one epoch, then ``--mode eval
  --checkpoint model_best``, with AABBs and then with OBBs
  (``--rotated_bbox``, the 2D projection loss on; ``resnet_tiny``), the AABB ``model_best``
  converted to flax's ``.msgpack`` (``tools/convert_weights``) and
  evaluated from it to the same files, a heatmap of its voxel scores
  (``tools/render_heatmap``);
- ``fcos`` (``test_torch_jax_free_fcos.py``): ``run_fcos --mode train`` and
  ``--mode eval --checkpoint model_best`` on OBB scenes (``train_fcos.sh``'s
  loss flags), on ``resnet_tiny`` (the Swin modules ran in ``rpn``);
- ``cnn`` (``test_torch_jax_free_cnn.py``): with ``resnet_tiny``, ``run_rpn
  --check_arch``, ``--mode train`` and ``--mode eval --save_results
  --output_all`` (the RCNN stage's files checked against the JAX CLI's
  layout), ``run_fcos --load_backbone_only --output_all --conv_at_start``
  from that checkpoint, ``run_rpn_detect --fine_tune`` for one epoch from
  it (``--pretrained``) and its eval, and one epoch of the quality gate.

An AST scan shows that no file of the port, and neither ``chip_smoke.py``
nor ``scripts/nccl_smoke.py``, names them in an import statement.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "nerf_rpn_tpu")

# every part starts with the block and ends with the check that nothing
# blocked reached ``sys.modules``
PRELUDE = r"""
import importlib, importlib.abc, os, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "nerf_rpn_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in the torch port")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import torch
torch.set_num_threads(2)  # beside the suite's other workers
"""

EPILOGUE = r"""
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("JAX_FREE_OK")
"""

PARTS = {}

# every module, a datatools CLI, and the Swin anchor RPN: AABB and OBB train
# and eval, the AABB checkpoint as flax's .msgpack evaluated again, a tool
PARTS["rpn"] = r"""
import importlib, pkgutil
import nerf_rpn_tpu_torch
for mod in pkgutil.walk_packages(nerf_rpn_tpu_torch.__path__, "nerf_rpn_tpu_torch."):
    importlib.import_module(mod.name)
for name in ("native", "datatools.nerf_features", "datatools.scannet_boxes",
             "datatools.hypersim_boxes", "datatools.prepare_scannet", "utils.debug",
             "utils.profiling", "parallel.space"):
    assert "nerf_rpn_tpu_torch." + name in sys.modules, name

# a datatools CLI as ``python -m`` runs it
import contextlib, io, runpy
argv, sys.argv = sys.argv, ["scannet_boxes", "--help"]
with contextlib.redirect_stdout(io.StringIO()) as out:
    try:
        runpy.run_module("nerf_rpn_tpu_torch.datatools.scannet_boxes", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
sys.argv = argv
assert "generate" in out.getvalue() and "filter" in out.getvalue(), out.getvalue()

from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_dataset
from nerf_rpn_tpu_torch.cli import run_rpn

# the OBB run on ``resnet_tiny``: the rotated losses and NMS do not depend
# on the backbone
for data, backbone, extra in (
        (sys.argv[1], "swin_t", []),
        (sys.argv[1] + "/obb", "resnet_tiny", ["--rotated_bbox", "--reg_loss_weight_2d", "0.5"])):
    write_synthetic_dataset(data, n_train=2, n_val=1, n_test=1, resolution=(32, 32, 32),
                            rotated=bool(extra))
    common = ["--backbone_type", backbone, "--resolution", "32",
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
    with np.load(data + "/out/proposals/synth003.npz") as z:
        assert z["proposal"].shape[1] == (7 if extra else 6), z["proposal"].shape

# the checkpoint as the flax .msgpack of the converter, evaluated again,
# and a tool on the voxel scores
from nerf_rpn_tpu_torch.tools import convert_weights, render_heatmap
data = sys.argv[1]
convert_weights.main(["--checkpoint", data + "/run/model_best", "--backbone_type", "swin_t",
                      "--out", data + "/run/model_best.msgpack"])
run_rpn.main(["--mode", "eval", "--checkpoint", data + "/run/model_best.msgpack",
              "--save_path", data + "/out_msgpack", "--output_proposals",
              "--output_voxel_scores", "--backbone_type", "swin_t", "--resolution", "32",
              "--rpn_head_conv_depth", "1", "--rpn_pre_nms_top_n_test", "64", "--rpn_post_nms_top_n_test", "32",
              "--device", "cpu", "--num_workers", "0", "--features_path", data,
              "--boxes_path", data, "--dataset_split", data + "/split.npz"])
for f in ("eval.json", "proposals/synth003.npz"):
    with open(f"{data}/out/{f}", "rb") as a, open(f"{data}/out_msgpack/{f}", "rb") as b:
        assert a.read() == b.read(), f
render_heatmap.render_scene("synth003", data + "/out_msgpack/voxel_scores",
                            data + "/heatmap", export_ply=True)
assert os.path.getsize(data + "/heatmap/synth003_heatmap.png") > 0
"""

# FCOS: train and eval on OBB scenes (``train_fcos.sh``'s loss flags), on
# ``resnet_tiny`` (the Swin modules ran in the ``rpn`` part)
PARTS["fcos"] = r"""
from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_dataset
from nerf_rpn_tpu_torch.cli import run_fcos
data = sys.argv[1] + "/obb"
write_synthetic_dataset(data, n_train=2, n_val=1, n_test=1, resolution=(32, 32, 32),
                        rotated=True)
common = ["--backbone_type", "resnet_tiny", "--resolution", "32", "--num_convs", "1",
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
"""

# the CNN backbones (BatchNorm statistics in the checkpoint), the drivers'
# other flags, the RCNN stage and the quality gate
PARTS["cnn"] = r"""
from nerf_rpn_tpu_torch.data.synthetic import write_synthetic_dataset
from nerf_rpn_tpu_torch.cli import run_fcos, run_rpn
data = sys.argv[1]
write_synthetic_dataset(data, n_train=2, n_val=1, n_test=1, resolution=(32, 32, 32))
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
"""


def run_part(part: str, work) -> None:
    """``PARTS[part]`` in a subprocess with the blocked packages blocked,
    ``work`` its scratch directory."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", PRELUDE + PARTS[part] + EPILOGUE, str(work)],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "JAX_FREE_OK" in res.stdout


def test_port_runs_the_cpu_slice_without_jax(tmp_path):
    run_part("rpn", tmp_path)


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
        Path(REPO, "chip_smoke.py"), Path(REPO, "scripts", "nccl_smoke.py")]
    assert len(files) > 30
    names = {str(f.relative_to(REPO)) for f in files}
    for new in ("ops/rotated_iou.py", "ops/fcos_box.py", "models/fcos.py",
                "cli/run_fcos.py", "ops/pooling.py", "models/resnet.py", "models/vgg.py",
                "cli/quality_gate.py", "ops/roi_align.py", "models/detector.py",
                "cli/run_rpn_detect.py", "train/flax_msgpack.py", "tools/convert_weights.py",
                "tools/proposals2ngp.py", "tools/render_heatmap.py", "tools/visualize_bbox.py",
                "tools/visualize_rpn_input.py", "native/__init__.py", "datatools/nerf_features.py",
                "datatools/scannet_boxes.py", "datatools/hypersim_boxes.py",
                "datatools/prepare_scannet.py", "utils/debug.py", "utils/profiling.py",
                "parallel/space.py"):
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
