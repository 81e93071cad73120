"""Torch port: the native C++ input-pipeline kernels (``nerf_rpn_tpu_torch/native``).

The port's library is built from its own copy of ``augment.cpp`` with the
JAX package's flags, so it must agree with the JAX package's library to
rounding (1e-6) and with the port's numpy twin within 5e-5; the port's
``rotate_and_scale`` (the loader's OBB augmentation) must give JAX's grid
within 1e-6 and its boxes exactly.  A failed build raises.
"""

import numpy as np
import pytest

from nerf_rpn_tpu import native as jax_native
from nerf_rpn_tpu.data import augment as jax_augment
from nerf_rpn_tpu.data.datasets import density_to_alpha_ngp, density_to_alpha_relu
from nerf_rpn_tpu_torch import native
from nerf_rpn_tpu_torch.data import augment

PAIRS = [(0.0, 1.0), (0.15, 0.95), (-0.1, 1.08)]
SHAPES = [(24, 24, 24, 4), (40, 36, 28, 4)]


@pytest.fixture(scope="module", autouse=True)
def jax_library(tmp_path_factory):
    """The JAX package's loader, pointed at a library of its own under a
    temporary directory: it builds its source with its flags there, and
    no other test process writes that file while this one loads it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB", str(tmp_path_factory.mktemp("jax_native") / "lib.so"))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_load_failed", False)
        assert jax_native.available(), "the JAX package's library did not build"
        yield


def _volume(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=["24cube", "40x36x28"])
@pytest.mark.parametrize("angle,scale", PAIRS)
def test_resample_matches_jax_library_and_numpy_twin(shape, angle, scale):
    vol = _volume(shape, 0)
    before = native.counts()["rotate_scale_resample"]
    got = native.rotate_scale_resample(vol, angle, scale)
    assert native.counts()["rotate_scale_resample"] == before + 1
    want = jax_native.rotate_scale_resample(vol, angle, scale)
    assert got.dtype == np.float32 and got.shape == vol.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    twin = augment.rotate_scale_resample_plain(vol, angle, scale)
    np.testing.assert_allclose(got, twin, rtol=0, atol=5e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=["24cube", "40x36x28"])
@pytest.mark.parametrize("angle,scale", PAIRS)
def test_rotate_and_scale_matches_jax(shape, angle, scale):
    vol = _volume(shape, 1)
    rng = np.random.default_rng(2)
    boxes = np.concatenate([rng.uniform(4, 20, (5, 3)), rng.uniform(2, 8, (5, 3)),
                            rng.uniform(-1.5, 1.5, (5, 1))], axis=1).astype(np.float32)
    got, got_boxes = augment.rotate_and_scale(vol, boxes, angle, scale)
    want, want_boxes = jax_augment.rotate_and_scale(vol, boxes, angle, scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got_boxes.dtype == want_boxes.dtype
    np.testing.assert_array_equal(got_boxes, want_boxes)


def test_loader_reaches_the_library():
    """``augment_rpn_inputs`` with ``rot_scale_prob=1`` on OBBs resamples
    through the library: its counter rises once a sample."""
    vol = _volume((16, 16, 12, 4), 3)
    boxes = np.array([[8, 8, 6, 4, 3, 2, 0.3]], np.float32)
    native.reset_counts()
    for seed in range(3):
        augment.augment_rpn_inputs(vol, boxes, np.random.default_rng(seed), rot_scale_prob=1.0)
    assert native.counts()["rotate_scale_resample"] == 3


@pytest.mark.parametrize("relu", [False, True], ids=["ngp", "relu"])
def test_density_to_alpha_matches_jax(relu):
    vol = np.random.default_rng(4).normal(size=(6, 7, 5, 4)).astype(np.float32) * 3
    got = vol.copy()
    assert native.density_to_alpha_inplace(got, relu=relu)
    want = vol.copy()
    assert jax_native.density_to_alpha_inplace(want, relu=relu)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ref = vol.copy()
    ref[..., -1] = (density_to_alpha_relu if relu else density_to_alpha_ngp)(ref[..., -1])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[..., :3], vol[..., :3])


def test_density_to_alpha_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="float32"):
        native.density_to_alpha_inplace(np.zeros((4, 4), np.float64))
    with pytest.raises(ValueError, match="contiguous"):
        native.density_to_alpha_inplace(np.zeros((4, 4), np.float32)[:, ::2])


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.rotate_scale_resample(_volume((4, 4, 4, 1), 5), 0.1, 1.0)
    assert not native.available()


def test_compile_error_raises_with_the_compilers_output(tmp_path, monkeypatch):
    src = tmp_path / "augment.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="augment.cpp"):
        native.library()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_carries_the_cpu(monkeypatch):
    """``-march=native`` code from another CPU must be rebuilt, not loaded."""
    monkeypatch.setattr(native, "cpu_identity", lambda: "x86_64\nflags: sse2 avx2")
    here = native.library_path()
    monkeypatch.setattr(native, "cpu_identity", lambda: "x86_64\nflags: sse2 avx2 avx512f")
    assert native.library_path() != here
    assert native.library_path().parent == here.parent


def test_library_is_hashed_once(monkeypatch):
    """After the first load a call takes the handle: no source re-hash."""
    handle = native.library()

    def no_hash():
        raise AssertionError("library_path() called after the library was loaded")

    monkeypatch.setattr(native, "library_path", no_hash)
    assert native.library() is handle
    vol = _volume((6, 5, 4, 2), 3)
    assert native.rotate_scale_resample(vol, 0.0, 1.0).shape == vol.shape
