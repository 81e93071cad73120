"""The torch port never imports jax, directly or through the JAX package.

A subprocess blocks jax / jaxlib / flax / optax / orbax with a meta-path
hook, imports every module of ``nerf_rpn_tpu_torch`` and runs the CPU slice
end to end through the CLI -- ``run_rpn --mode train`` for one epoch on a
synthetic 32^3 dataset, then ``--mode eval --checkpoint model_best`` --
and checks that none of them reached ``sys.modules``.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in the torch port")
        return None

sys.meta_path.insert(0, Block())

import nerf_rpn_tpu_torch
for mod in pkgutil.walk_packages(nerf_rpn_tpu_torch.__path__, "nerf_rpn_tpu_torch."):
    importlib.import_module(mod.name)

from nerf_rpn_tpu.data.synthetic import write_synthetic_dataset
from nerf_rpn_tpu_torch.cli import run_rpn

data = sys.argv[1]
write_synthetic_dataset(data, n_train=2, n_val=1, n_test=1, resolution=(32, 32, 32))
common = ["--backbone_type", "swin_t", "--resolution", "32",
          "--rpn_head_conv_depth", "1", "--rpn_pre_nms_top_n_test", "64",
          "--rpn_post_nms_top_n_test", "32", "--device", "cpu", "--num_workers", "0",
          "--features_path", data, "--boxes_path", data,
          "--dataset_split", data + "/split.npz"]
logged = run_rpn.main(["--mode", "train", "--num_epochs", "1", "--log_interval", "1",
                       "--save_path", data + "/run", *common])
assert len(logged) == 2 and all(m["loss"] > 0 for m in logged), logged
run_rpn.main(["--mode", "eval", "--checkpoint", data + "/run/model_best",
              "--save_path", data + "/out", *common])
import os
assert os.path.exists(data + "/out/eval.json")
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
