"""Host-side C++ kernels of the input pipeline (``augment.cpp``), via ctypes.

The counterpart of ``nerf_rpn_tpu/native``: the same source and the same
compiler flags (``g++ -O3 -march=native -shared -fPIC``), so the two
libraries compute the same thing on one machine.  The library is built at
first use into ``nerf_rpn_tpu_torch/build/`` (listed in ``.gitignore``)
under a name that carries a hash of the source, the compiler, the flags
and the host's CPU (``-march=native`` targets it), so an edited source
rebuilds and a library built on another CPU is rebuilt, not loaded.  The
name is worked out once, at first use in a process; later calls take the
loaded handle.  Nothing is built or loaded when this module is imported.

Unlike the JAX package's loader, nothing here falls back to numpy: a failed
build raises with the compiler's output, and the numpy resample
(``data.augment.rotate_scale_resample_plain``) is the twin that tests and
``chip_smoke.py`` hold this library to, not a path the loader takes.

Each entry point counts its calls in :data:`COUNTS` (as ``kernels.counts()``
does for the CUDA kernels), so a run can show that the loader went through
the library.  ctypes releases the GIL for the length of a call, so the
loader's worker threads resample in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "augment.cpp"
BUILD = _DIR.parent / "build"
# the compiler; tests point it elsewhere to see a failed build raise
CXX = "g++"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
# the four exports of augment.cpp's extern "C" block
SIGNATURES = {
    "rotate_scale_resample": [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_float, ctypes.c_float, _F32P],
    "density_to_alpha_ngp": [_F32P, ctypes.c_int64, ctypes.c_int],
    "density_to_alpha_relu": [_F32P, ctypes.c_int64, ctypes.c_int],
    "u8_to_unit_float": [_U8P, ctypes.c_int64, _F32P],
}

# calls per entry point, counted where its wrapper calls it
COUNTS = {name: 0 for name in SIGNATURES}
_lock = threading.Lock()
# (SRC, BUILD, CXX, FLAGS) -> the loaded library
_loaded: dict[tuple, ctypes.CDLL] = {}


def reset_counts() -> None:
    with _lock:
        for name in COUNTS:
            COUNTS[name] = 0


def counts() -> dict[str, int]:
    with _lock:
        return dict(COUNTS)


def _count(name: str) -> None:
    with _lock:
        COUNTS[name] += 1


def cpu_identity() -> str:
    """The machine and the first ``model name`` and ``flags`` lines of
    ``/proc/cpuinfo`` (``Features`` and ``CPU part`` on ARM), where it exists."""
    keys = ("model name", "flags", "Features", "CPU part")
    found = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in keys and key not in found:
                    found[key] = value.strip()
    except OSError:
        found["processor"] = platform.processor()
    return "\n".join([platform.machine(), *(f"{k}: {found[k]}" for k in sorted(found))])


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join([CXX, *FLAGS]).encode())
    h.update(cpu_identity().encode())
    return BUILD / f"libnerf_rpn_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``augment.cpp`` unless an up-to-date library exists; raise
    with the compiler's output if it fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [CXX, *FLAGS, str(SRC), "-o", tmp]
    try:
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the C++ compiler {CXX!r} to build "
                               f"{SRC.name}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(
                f"{CXX} failed for {SRC.name} (exit {res.returncode}):\n"
                f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def library() -> ctypes.CDLL:
    """The loaded library (built on first use) with its signatures set.  The
    source is hashed once for each setting of ``SRC``, ``BUILD``, ``CXX`` and
    ``FLAGS``; later calls return the handle without taking the lock."""
    key = (SRC, BUILD, CXX, tuple(FLAGS))
    handle = _loaded.get(key)
    if handle is not None:
        return handle
    with _lock:
        if key not in _loaded:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                getattr(handle, name).argtypes = argtypes
                getattr(handle, name).restype = None
            _loaded[key] = handle
        return _loaded[key]


def available() -> bool:
    """Whether the library builds and loads here (a query: no entry point
    consults it)."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def rotate_scale_resample(volume: np.ndarray, angle: float, scale: float) -> np.ndarray:
    """(W, L, H, C) float32 -> its trilinear resample on the grid turned by
    ``angle`` about +z and scaled by ``scale`` (a new array)."""
    if np.ndim(volume) != 4:
        raise ValueError(f"expected a (W, L, H, C) volume, got shape {np.shape(volume)}")
    lib = library()
    src = np.ascontiguousarray(volume, np.float32)
    dst = np.empty_like(src)
    w, l, h, c = src.shape
    lib.rotate_scale_resample(src.ctypes.data_as(_F32P), w, l, h, c, ctypes.c_float(angle),
                              ctypes.c_float(scale), dst.ctypes.data_as(_F32P))
    _count("rotate_scale_resample")
    return dst


def density_to_alpha_inplace(rgbsigma: np.ndarray, relu: bool = False) -> bool:
    """Density -> alpha on the last channel, in place (instant-ngp's
    ``exp`` activation, or ReLU with ``relu``).  Takes a C-contiguous
    float32 array and raises on any other; returns True."""
    if rgbsigma.dtype != np.float32 or not rgbsigma.flags.c_contiguous:
        raise ValueError("density_to_alpha_inplace needs a C-contiguous float32 array, got "
                         f"{rgbsigma.dtype} (contiguous: {rgbsigma.flags.c_contiguous})")
    lib = library()
    name = "density_to_alpha_relu" if relu else "density_to_alpha_ngp"
    c = rgbsigma.shape[-1]
    getattr(lib, name)(rgbsigma.ctypes.data_as(_F32P), rgbsigma.size // c, c)
    _count(name)
    return True
