"""Torch port: ``nerf_rpn_tpu_torch.datatools`` against the JAX package's.

Every function that ``tests/test_scannet_prep.py`` and ``tests/test_tools.py``
import from ``nerf_rpn_tpu.datatools`` runs through both packages on the
same seeded inputs: outputs and written files equal byte for byte.  The
NeRF extraction takes a numpy callable in the JAX package and a
``torch.nn.Module`` in the port (``device="cpu"``); in float64 they agree
within 1e-10.  The box files that the synthetic ScanNet and Hypersim scenes
give are pinned by the digests beside their writers in
``data/synthetic.py``, which ``chip_smoke.py`` phase 30 also holds the card
machine's files to.
"""

import hashlib
import json
import os
import sqlite3

import numpy as np
import pytest
import torch

from nerf_rpn_tpu.datatools import hypersim_boxes as jax_hypersim
from nerf_rpn_tpu.datatools import nerf_features as jax_features
from nerf_rpn_tpu.datatools import prepare_scannet as jax_prepare
from nerf_rpn_tpu.datatools import scannet_boxes as jax_scannet
from nerf_rpn_tpu_torch.data.synthetic import (HYPERSIM_NPY_SHA256, SCANNET_NPY_SHA256,
                                               write_hypersim_scene, write_scannet_scene)
from nerf_rpn_tpu_torch.datatools import hypersim_boxes, nerf_features, prepare_scannet
from nerf_rpn_tpu_torch.datatools import scannet_boxes


def _sha256(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _same_tree(a, b):
    """Two directory trees with the same files, byte for byte."""
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    assert files
    for f in files:
        with open(os.path.join(a, f), "rb") as x, open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


def _equal(a, b):
    """Equal results, arrays bit for bit (and of one dtype)."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b


# ---------------------------------------------------------------------------
# prepare_scannet
# ---------------------------------------------------------------------------


def _random_rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def test_frame_sampling_and_pose_math_match_jax():
    rng = np.random.default_rng(0)
    for n, num_train, num_val in ((10, 3, 2), (7, 3, 1), (2, 100, 5), (40, 6, 4)):
        frames = sorted(rng.choice(200, n, replace=False).tolist())
        score = {f: float(rng.normal()) for f in frames}
        got = prepare_scannet.sample_train_frames(frames, num_train, score.get)
        want = jax_prepare.sample_train_frames(frames, num_train, score.get)
        _equal(got, want)
        _equal(prepare_scannet.sample_val_frames(frames, got[0], got[1], num_val, score.get),
               jax_prepare.sample_val_frames(frames, want[0], want[1], num_val, score.get))
    for _ in range(20):
        r = _random_rotation(rng)
        _equal(prepare_scannet.rotmat_to_quat_wxyz(r), jax_prepare.rotmat_to_quat_wxyz(r))
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = r, rng.normal(size=3)
        _equal(prepare_scannet.pose_to_colmap_qt(pose), jax_prepare.pose_to_colmap_qt(pose))


def test_colmap_commands_and_images_txt_match_jax(tmp_path):
    for gpus in (None, [0], [0, 2]):
        _equal(prepare_scannet.sfm_commands("/data/s", gpus), jax_prepare.sfm_commands("/data/s", gpus))
        _equal(prepare_scannet.process_commands("/data/s", "/t.txt", gpus),
               jax_prepare.process_commands("/data/s", "/t.txt", gpus))
    lines = ["# a\n", "# b\n"] + [f"{i} 0.9 0.1 0 0 1 2 3 1 {i}00.jpg\n" for i in (1, 2, 3)]
    args = (lines, ["100.jpg", "300.jpg"], {"100.jpg": 7, "300.jpg": 8})
    _equal(prepare_scannet.build_train_images_txt(*args), jax_prepare.build_train_images_txt(*args))
    (tmp_path / "images.txt").write_text("".join(["# h\n"] * 4 + ["1 x\n", "\n"] * 5))
    assert (prepare_scannet.count_reconstructed_images(str(tmp_path / "images.txt"))
            == jax_prepare.count_reconstructed_images(str(tmp_path / "images.txt")) == 5)
    (tmp_path / "cam.txt").write_text("colorWidth = 1296\nfx_color = 1170.2\n")
    assert (prepare_scannet.read_fx_color(str(tmp_path / "cam.txt"))
            == jax_prepare.read_fx_color(str(tmp_path / "cam.txt")))
    (tmp_path / "bad.txt").write_text("fy_color = 1.0\n")
    for mod in (prepare_scannet, jax_prepare):
        with pytest.raises(ValueError):
            mod.read_fx_color(str(tmp_path / "bad.txt"))


def _scannet_scene(root, n=14, seed=0):
    """A ScanNet ``extract/`` layout: ``n`` small JPEG frames (random
    blur, so sharpness ranks them), their poses (frame 5's not finite,
    frame 9's missing) and the camera file."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    scene = root / "scene0000_00"
    for sub in ("color", "pose", "intrinsic"):
        (scene / "extract" / sub).mkdir(parents=True)
    for i in range(n):
        img = rng.integers(0, 255, (24, 32)).astype(np.float32)
        for _ in range(int(rng.integers(0, 3))):
            img = (np.roll(img, 1, 0) + img + np.roll(img, -1, 1)) / 3
        Image.fromarray(img.astype(np.uint8)).save(scene / "extract" / "color" / f"{i}.jpg")
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = _random_rotation(rng), rng.normal(size=3)
        if i == 5:
            pose[2, 3] = np.nan
        if i != 9:
            np.savetxt(scene / "extract" / "pose" / f"{i}.txt", pose)
    (scene / "scene0000_00.txt").write_text("colorWidth = 1296\nfx_color = 1170.2\n")
    return scene


def test_prepare_scene_sharpness_and_cli_match_jax(tmp_path):
    scene = _scannet_scene(tmp_path / "scans")
    color = scene / "extract" / "color"
    for i in range(4):
        assert prepare_scannet.sharpness(str(color / f"{i}.jpg")) == \
            jax_prepare.sharpness(str(color / f"{i}.jpg"))
    frames = list(range(14))
    assert prepare_scannet.validate_poses(frames, str(scene / "extract" / "pose")) == \
        jax_prepare.validate_poses(frames, str(scene / "extract" / "pose"))
    got = prepare_scannet.prepare_scene(str(scene), str(tmp_path / "port"), 4, 2, 5)
    want = jax_prepare.prepare_scene(str(scene), str(tmp_path / "jax"), 4, 2, 5)
    _equal(got, want)
    _same_tree(tmp_path / "port", tmp_path / "jax")
    argv = ["--scannet_path", str(tmp_path / "scans"), "--num_train_samples", "3",
            "--num_val_samples", "3", "--min_valid_frames", "4"]
    prepare_scannet.main(argv + ["--output_path", str(tmp_path / "port_cli")])
    jax_prepare.main(argv + ["--output_path", str(tmp_path / "jax_cli")])
    _same_tree(tmp_path / "port_cli", tmp_path / "jax_cli")


def _colmap_db(path, names):
    db = sqlite3.connect(path)
    db.execute("CREATE TABLE cameras (camera_id INTEGER PRIMARY KEY, model INTEGER, "
               "width INTEGER, height INTEGER, params BLOB, prior_focal_length INTEGER)")
    db.execute("CREATE TABLE images (image_id INTEGER PRIMARY KEY, name TEXT, "
               "camera_id INTEGER)")
    db.execute("INSERT INTO cameras VALUES (1, 0, 648, 486, ?, 1)",
               (np.array([600.0, 324.0, 243.0]).tobytes(),))
    for i, n in enumerate(names, start=1):
        db.execute("INSERT INTO images VALUES (?, ?, 1)", (i, n))
    db.commit()
    db.close()


def test_write_ground_truth_poses_matches_jax(tmp_path):
    scene = _scannet_scene(tmp_path / "scans")
    names = [f"{i}.jpg" for i in (0, 3, 7, 12)]
    out = {}
    for tag, mod in (("port", prepare_scannet), ("jax", jax_prepare)):
        sparse = tmp_path / tag / "sparse"
        sparse.mkdir(parents=True)
        _colmap_db(str(tmp_path / tag / "db.db"), names)
        mod.write_ground_truth_poses(str(sparse), str(tmp_path / tag / "db.db"),
                                     str(scene / "extract" / "pose"),
                                     str(scene / "scene0000_00.txt"))
        db = sqlite3.connect(str(tmp_path / tag / "db.db"))
        out[tag] = [list(db.execute(f"SELECT * FROM {t}")) for t in ("cameras", "images")]
        db.close()
    _same_tree(tmp_path / "port" / "sparse", tmp_path / "jax" / "sparse")
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# scannet_boxes and hypersim_boxes
# ---------------------------------------------------------------------------


def test_scannet_geometry_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    for pts in (rng.normal(size=(50, 2)), rng.normal(size=(2, 2)), np.ones((3, 2)),
                rng.integers(0, 4, (30, 2)).astype(np.float64)):
        _equal(scannet_boxes.convex_hull_2d(pts), jax_scannet.convex_hull_2d(pts))
        _equal(scannet_boxes.minimum_bounding_rectangle(pts),
               jax_scannet.minimum_bounding_rectangle(pts))
    v = rng.normal(size=(80, 3)).astype(np.float32)
    _equal(scannet_boxes.instance_obb(v), jax_scannet.instance_obb(v))
    scans = write_scannet_scene(str(tmp_path))
    ply = os.path.join(scans, "scene0000_00", "scene0000_00_vh_clean_2.ply")
    _equal(scannet_boxes.read_ply_vertices(ply), jax_scannet.read_ply_vertices(ply))
    ascii_ply = tmp_path / "ascii.ply"
    ascii_ply.write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                         "property float y\nproperty float z\nproperty uchar red\n"
                         "end_header\n0 1 2 7\n3.5 4 5 8\n-1 0.25 6 9\n")
    _equal(scannet_boxes.read_ply_vertices(str(ascii_ply)),
           jax_scannet.read_ply_vertices(str(ascii_ply)))


def test_scannet_cli_matches_jax_and_the_pinned_file(tmp_path):
    scans = write_scannet_scene(str(tmp_path))
    feats = str(tmp_path / "features")
    for tag, mod in (("port", scannet_boxes), ("jax", jax_scannet)):
        mod.main(["generate", "--scene_path", scans, "--output_path", str(tmp_path / tag / "json")])
        mod.main(["filter", "--feature_path", feats, "--json_path", str(tmp_path / tag / "json"),
                  "--output_path", str(tmp_path / tag / "boxes")])
    _same_tree(tmp_path / "port", tmp_path / "jax")
    boxes = np.load(tmp_path / "port" / "boxes" / "scene0000_00.npy")
    # the filter drops the excluded label ('wall') and the 5 cm instance
    assert boxes.shape == (4, 7)
    assert _sha256(tmp_path / "port" / "boxes" / "scene0000_00.npy") == SCANNET_NPY_SHA256


def test_filter_boxes_without_instances_matches_jax(tmp_path):
    np.savez(tmp_path / "feat.npz", resolution=np.array([16, 16, 16]))
    (tmp_path / "scene.json").write_text(json.dumps({"instances": []}))
    for tag, mod in (("port", scannet_boxes), ("jax", jax_scannet)):
        mod.filter_boxes(str(tmp_path / "feat.npz"), str(tmp_path / "scene.json"),
                         str(tmp_path / f"{tag}.npy"), str(tmp_path / f"{tag}.json"))
    assert _sha256(tmp_path / "port.npy") == _sha256(tmp_path / "jax.npy")


def test_hypersim_conversions_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    m = np.hstack([_random_rotation(rng), rng.normal(size=(3, 1))])
    for mitsuba in (False, True):
        _equal(hypersim_boxes.nerf_matrix_to_ngp(m, 1.3, np.array([0.5, 0.4, 0.2]), mitsuba),
               jax_hypersim.nerf_matrix_to_ngp(m, 1.3, np.array([0.5, 0.4, 0.2]), mitsuba))
    dataset = write_hypersim_scene(str(tmp_path))
    with open(os.path.join(dataset, "ai_001_001", "train", "transforms.json")) as f:
        json_dict = json.load(f)
    params = dict(np.load(tmp_path / "features" / "ai_001_001.npz"))
    for fmt in ("aabbs", "obbs"):
        for flags in ((False, False, 2), (True, True, 10)):
            _equal(getattr(hypersim_boxes, f"process_{fmt}")(json_dict, params, *flags),
                   getattr(jax_hypersim, f"process_{fmt}")(json_dict, params, *flags))
    (tmp_path / "manual.csv").write_text("box_id,manually_filtered\n1,1\n3,0\n4,1\n")
    got = hypersim_boxes.apply_manual_filters(json.loads(json.dumps(json_dict)),
                                              str(tmp_path / "manual.csv"))
    want = jax_hypersim.apply_manual_filters(json.loads(json.dumps(json_dict)),
                                             str(tmp_path / "manual.csv"))
    assert got == want and sum(b["manually_filtered"] for b in got["bounding_boxes"]) == 2


def test_hypersim_labels_from_hdf5_match_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    dataset = write_hypersim_scene(str(tmp_path))
    with open(os.path.join(dataset, "ai_001_001", "train", "transforms.json")) as f:
        json_dict = json.load(f)
    n = len(json_dict["bounding_boxes"])
    rng = np.random.default_rng(5)
    ext = rng.uniform(0.1, 1, (n + 2, 3))
    ext[[2, 6]] = np.inf  # hdf5 rows without a box
    mesh, sem = tmp_path / "mesh", tmp_path / "sem"
    mesh.mkdir()
    sem.mkdir()
    for name, data in (
            ("metadata_semantic_instance_bounding_box_object_aligned_2d_extents.hdf5", ext),
            ("metadata_semantic_instance_bounding_box_object_aligned_2d_orientations.hdf5",
             np.zeros((n + 2, 3, 3)))):
        with h5py.File(mesh / name, "w") as f:
            f["dataset"] = data
    with h5py.File(sem / "mesh_objects_si.hdf5", "w") as f:
        f["dataset"] = rng.integers(1, 41, (30, 1))
    with h5py.File(sem / "mesh_objects_sii.hdf5", "w") as f:
        f["dataset"] = rng.integers(-1, n + 2, (30, 1))
    got, want = json.loads(json.dumps(json_dict)), json.loads(json.dumps(json_dict))
    hypersim_boxes.load_and_add_labels(got, str(mesh), str(sem))
    jax_hypersim.load_and_add_labels(want, str(mesh), str(sem))
    assert got == want


@pytest.mark.parametrize("fmt", ["obb", "aabb"])
def test_hypersim_cli_matches_jax_and_the_pinned_file(tmp_path, fmt):
    dataset = write_hypersim_scene(str(tmp_path))
    for tag, mod in (("port", hypersim_boxes), ("jax", jax_hypersim)):
        mod.main(["--format", fmt, "--dataset_dir", dataset,
                  "--feature_dir", str(tmp_path / "features"),
                  "--output_dir", str(tmp_path / tag), "--filter_by_size"])
    _same_tree(tmp_path / "port", tmp_path / "jax")
    boxes = np.load(tmp_path / "port" / "ai_001_001.npy")
    assert boxes.shape[1] == (7 if fmt == "obb" else 6) and 0 < len(boxes) < 8
    assert _sha256(tmp_path / "port" / "ai_001_001.npy") == HYPERSIM_NPY_SHA256[fmt]


def test_datatools_clis_keep_their_flags(capsys):
    for mod, jax_mod in ((scannet_boxes, jax_scannet), (hypersim_boxes, jax_hypersim),
                         (prepare_scannet, jax_prepare)):
        helps = []
        for m in (mod, jax_mod):
            with pytest.raises(SystemExit) as e:
                m.main(["--help"])
            assert e.value.code == 0
            helps.append(capsys.readouterr().out)
        assert helps[0] == helps[1]


# ---------------------------------------------------------------------------
# nerf_features: a small dense-depth-priors-style NeRF, numpy and torch
# ---------------------------------------------------------------------------


def _embed_np(x, freqs):
    return np.concatenate([x] + [f(x * 2.0 ** k) for k in range(freqs)
                                 for f in (np.sin, np.cos)], -1)


def _embed_torch(x, freqs):
    return torch.cat([x] + [f(x * 2.0 ** k) for k in range(freqs)
                            for f in (torch.sin, torch.cos)], -1)


def _nerf_weights(seed=0, width=16, pos_freqs=3, dir_freqs=2):
    rng = np.random.default_rng(seed)
    cin, cdir = 3 + 6 * pos_freqs, 3 + 6 * dir_freqs
    shapes = [(cin, width), (width, width), (width + cin, width), (width, width),
              (width, 1), (width, width), (width + cdir, width // 2), (width // 2, 3)]
    return [(rng.normal(size=s) / np.sqrt(s[0]), rng.normal(size=s[1]) * 0.1) for s in shapes]


def _nerf_numpy(weights, pts, viewdir, pos_freqs=3, dir_freqs=2):
    """raw (N, 4): 4 point layers with the input skip into the third,
    sigma from the point features, rgb through the view layer."""
    lin = lambda i, x: x @ weights[i][0] + weights[i][1]
    e = _embed_np(np.asarray(pts, np.float64), pos_freqs)
    h = e
    for i in range(4):
        h = np.maximum(lin(i, h), 0)
        if i == 1:
            h = np.concatenate([e, h], -1)
    d = _embed_np(np.broadcast_to(np.asarray(viewdir, np.float64), (len(pts), 3)), dir_freqs)
    v = np.maximum(lin(6, np.concatenate([lin(5, h), d], -1)), 0)
    return np.concatenate([lin(7, v), lin(4, h)], -1)


class _NeRFTorch(torch.nn.Module):
    def __init__(self, weights, pos_freqs=3, dir_freqs=2):
        super().__init__()
        self.pos_freqs, self.dir_freqs = pos_freqs, dir_freqs
        self.layers = torch.nn.ModuleList()
        for w, b in weights:
            lin = torch.nn.Linear(*w.shape, dtype=torch.float64)
            lin.weight.data = torch.from_numpy(w.T.copy())
            lin.bias.data = torch.from_numpy(b.copy())
            self.layers.append(lin)

    def forward(self, pts, viewdir):
        e = _embed_torch(pts.double(), self.pos_freqs)
        h = e
        for i in range(4):
            h = torch.relu(self.layers[i](h))
            if i == 1:
                h = torch.cat([e, h], -1)
        d = _embed_torch(viewdir.double().expand(len(pts), 3), self.dir_freqs)
        v = torch.relu(self.layers[6](torch.cat([self.layers[5](h), d], -1)))
        return torch.cat([self.layers[7](v), self.layers[4](h)], -1)


def _poses(n, seed=6):
    rng = np.random.default_rng(seed)
    return np.stack([np.hstack([_random_rotation(rng), rng.normal(size=(3, 1))])
                     for _ in range(n)])


def test_grid_helpers_match_jax():
    for centers in (True, False):
        for bmin, bmax, res in (([0, 0, 0], [2, 1, 1], 8), ([-1.5, -1, -0.2], [1.5, 1, 0.7], 11)):
            _equal(nerf_features.build_sample_grid(bmin, bmax, res, centers),
                   jax_features.build_sample_grid(bmin, bmax, res, centers))
    grid = np.random.default_rng(7).normal(size=(5, 4, 3, 4)).astype(np.float32)
    flat = nerf_features.grid_to_ddp_flat(grid)
    _equal(flat, jax_features.grid_to_ddp_flat(grid))
    _equal(nerf_features.ddp_flat_to_grid(flat, (5, 4, 3)),
           jax_features.ddp_flat_to_grid(flat, (5, 4, 3)))


def test_mean_rgb_over_poses_matches_jax():
    weights, poses = _nerf_weights(), _poses(3)
    pts = np.random.default_rng(8).uniform(-1, 1, (500, 3)).astype(np.float32)
    net = _NeRFTorch(weights)
    want_rgb, want_sigma = jax_features.mean_rgb_over_poses(
        lambda p, d: _nerf_numpy(weights, p, d), poses, pts, chunk=128)
    got_rgb, got_sigma = nerf_features.mean_rgb_over_poses(net, poses, pts, chunk=128)
    assert got_rgb.dtype == torch.float32 and got_sigma.dtype == torch.float32
    np.testing.assert_allclose(got_rgb.numpy(), want_rgb, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got_sigma.numpy(), want_sigma, rtol=0, atol=1e-10)


@pytest.mark.parametrize("centers,ddp_layout", [(True, False), (False, True)])
def test_extract_rgbsigma_matches_jax(tmp_path, centers, ddp_layout):
    weights, poses = _nerf_weights(1), _poses(4)
    net = _NeRFTorch(weights)
    bbox = ([-1.0, -0.8, -0.3], [1.0, 0.6, 0.5])
    kw = dict(max_res=12, chunk=100, centers=centers, ddp_layout=ddp_layout, scale=1.5,
              offset=(0.5, 0.25, 0.0), extra_arrays={"note": np.arange(3)})
    want, want_res = jax_features.extract_rgbsigma(
        lambda p: jax_features.mean_rgb_over_poses(lambda q, d: _nerf_numpy(weights, q, d),
                                                   poses, p, chunk=64),
        *bbox, output_file=str(tmp_path / "jax.npz"), **kw)
    got, got_res = nerf_features.extract_rgbsigma(
        lambda p: nerf_features.mean_rgb_over_poses(net, poses, p, chunk=64),
        *bbox, output_file=str(tmp_path / "port.npz"), device="cpu", **kw)
    assert got.dtype == want.dtype and got.shape == want.shape == (12, 8, 5, 4)
    _equal(got_res, want_res)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if k == "rgbsigma":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-10)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_extract_rgbsigma_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        nerf_features.extract_rgbsigma(lambda p: (p, p[:, 0]), [0, 0, 0], [1, 1, 1], max_res=2)
