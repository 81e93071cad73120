"""Build the hand-written CUDA kernels in ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with ``nvcc`` for ``sm_90a`` (Hopper) into ``nerf_rpn_tpu_torch/build/``
(listed in ``.gitignore``); the library name carries a hash of the source
and flags, so an edited source rebuilds.  Nothing is built or loaded when
this module is imported, and nothing catches a failed build: the first call
of a kernel on a CUDA tensor raises instead.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises on a nonzero code.  Each kernel
wrapper counts its launches in :data:`COUNTS`, so a run can show that the
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# per-library extra flags; K3's IoU bits must match the plain version
# exactly, so it is built without FMA contraction (and never fast-math)
KERNEL_FLAGS = {
    "window_attention": ["-O3"],
    "window_attention_bwd": ["-O3"],
    "nms_graph": ["-O3", "--fmad=false"],
    "fused_ln_qkv": ["-O3"],
    "fused_mlp": ["-O3"],
}

# dtype codes of the C entry points (csrc/common.cuh DtypeCode); the
# kernels take f32 and bf16 tensors
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# C signatures: name -> (library, argtypes); every entry returns int
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "window_attention_fwd": (
        "window_attention",
        # qkv, bias, mask|NULL, out, W, H, C, nW, head group, dtype_code,
        # scale, stream
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
    "window_attention_bwd": (
        "window_attention_bwd",
        # qkv, dout, bias, mask|NULL, dqkv, dbias_part, dbias, W, H, C, nW,
        # window runs, dtype_code, scale, stream
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
    "aabb_suppression_graph": (
        "nms_graph",
        # boxes, out, P, Np, thresh, stream
        [_P, _P, _I, _I, _F, _P]),
    "nms_resolve": (
        "nms_graph",
        # graph, svalid, alive, P, Np, stream
        [_P, _P, _P, _I, _I, _P]),
    "fused_window_attention": (
        "window_attention",
        # q, k, v, strides (host int64[12]), bias, table, ids, out, W, H, D,
        # P, head group, dtype_code, scale, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
    "ln_partition_qkv": (
        "fused_ln_qkv",
        # x, ln_scale, ln_bias, w (3C, C), b, out, B, SX, SY, SZ, C, PX, PY,
        # PZ, shift x/y/z, window x/y/z, x slab origin / real size / first
        # window column / window columns, plan rows / cols / k_chunk /
        # group, dtype_code, stream
        [_P, _P, _P, _P, _P, _P, *[_I] * 23, _P]),
    "fused_mlp_block": (
        "fused_mlp",
        # x, ln_scale, ln_bias, w1 (Hd, C), b1, w2 (C, Hd), b2, out,
        # part|NULL, T, C, Hd, plan rows / splits / cols / k_chunk,
        # dtype_code, eps, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, *[_I] * 8, _F, _P]),
}


# launches per C entry point, counted where the wrapper launches it
COUNTS = {name: 0 for name in SIGNATURES}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def counts() -> dict[str, int]:
    return dict(COUNTS)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are "
            "built from csrc/ at first use and need the CUDA toolkit")
    return path


def nvcc_flags(lib: str) -> list[str]:
    """Target and code-generation flags of ``csrc/<lib>.cu``."""
    return [*_ARCH, "-std=c++17", *KERNEL_FLAGS[lib]]


def _library_path(lib: str) -> tuple[Path, list[str]]:
    src = CSRC / f"{lib}.cu"
    flags = [*nvcc_flags(lib), "-shared", "-Xcompiler", "-fPIC"]
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD / f"lib{lib}_{h.hexdigest()[:16]}.so", flags


def build(lib: str) -> Path:
    """Compile ``csrc/<lib>.cu`` unless an up-to-date library exists."""
    out, flags = _library_path(lib)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [nvcc(), *flags, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{lib}.cu")]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {lib}.cu (exit {res.returncode}):\n"
                f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


_loaded: dict[str, ctypes.CDLL] = {}


def library(lib: str) -> ctypes.CDLL:
    """The loaded library (built on first use) with its signatures set."""
    if lib not in _loaded:
        handle = ctypes.CDLL(str(build(lib)))
        for fn, (owner, argtypes) in SIGNATURES.items():
            if owner == lib:
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = ctypes.c_int
        handle.nrt_error_string.argtypes = [ctypes.c_int]
        handle.nrt_error_string.restype = ctypes.c_char_p
        _loaded[lib] = handle
    return _loaded[lib]


def build_all() -> float:
    """Build every kernel library, one ``nvcc`` per source all started
    together, then load them; returns the seconds it took."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_FLAGS)) as pool:
        for fut in [pool.submit(build, lib) for lib in KERNEL_FLAGS]:
            fut.result()
    for lib in KERNEL_FLAGS:
        library(lib)
    return time.perf_counter() - t0


def launch(fn: str, *args) -> None:
    """Call C entry ``fn``; raise on a nonzero ``cudaError_t``; count it."""
    lib = library(SIGNATURES[fn][0])
    code = getattr(lib, fn)(*args)
    if code != 0:
        msg = lib.nrt_error_string(code).decode()
        raise RuntimeError(f"{fn}: CUDA error {code}: {msg}")
    COUNTS[fn] += 1
