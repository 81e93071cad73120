"""The port's host tools (``nerf_rpn_tpu_torch/tools/``) against the JAX
package's (``nerf_rpn_tpu/tools/``) on the same numpy inputs: the cases of
``tests/test_tools.py`` that concern ``proposals2ngp``,
``visualize_rpn_input``, ``render_heatmap`` and ``visualize_bbox``, run
through both.  Arrays must be equal, floats within 1e-6; written files
(JSON, PLY, PNG) byte for byte.  ``convert_weights`` has its cases in
``test_torch_checkpoint_formats.py``.
"""

import json
import sys

import numpy as np
import pytest

from nerf_rpn_tpu.tools import proposals2ngp as jp2n
from nerf_rpn_tpu.tools import render_heatmap as jheat
from nerf_rpn_tpu.tools import visualize_bbox as jbbox
from nerf_rpn_tpu.tools import visualize_rpn_input as jvis
from nerf_rpn_tpu_torch.tools import proposals2ngp as tp2n
from nerf_rpn_tpu_torch.tools import render_heatmap as theat
from nerf_rpn_tpu_torch.tools import visualize_bbox as tbbox
from nerf_rpn_tpu_torch.tools import visualize_rpn_input as tvis


def _scene_params(offset=(0.0, 0.0, 0.0), mitsuba=False):
    return {
        "resolution": np.array([32, 32, 32], np.float64),
        "bbox_min": np.array([-1.0, -1.0, -1.0]),
        "bbox_max": np.array([1.0, 1.0, 1.0]),
        "scale": 1.0 if not mitsuba else 0.5,
        "offset": np.array(offset),
        "from_mitsuba": mitsuba,
    }


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=1e-6)


def _same_boxes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            _close(g[k], w[k])


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


@pytest.mark.parametrize("mitsuba", [False, True])
def test_ngp_matrix_to_nerf(mitsuba):
    rng = np.random.default_rng(0)
    m = np.hstack([np.linalg.qr(rng.normal(size=(3, 3)))[0], rng.normal(size=(3, 1))])
    offset = np.array([0.1, 0.2, 0.3])
    _close(tp2n.ngp_matrix_to_nerf(m, 0.5, offset, mitsuba),
           jp2n.ngp_matrix_to_nerf(m, 0.5, offset, mitsuba))


@pytest.mark.parametrize("params", [_scene_params(), _scene_params(0.25, True)],
                         ids=["plain", "mitsuba_scalar_offset"])
def test_proposals_to_ngp(params):
    rng = np.random.default_rng(1)
    lo = rng.uniform(0, 20, (5, 3))
    aabbs = np.concatenate([lo, lo + rng.uniform(1, 10, (5, 3))], 1).astype(np.float32)
    _same_boxes(tp2n.aabb_proposals_to_ngp(aabbs, params),
                jp2n.aabb_proposals_to_ngp(aabbs, params))
    obbs = np.concatenate([rng.uniform(4, 28, (5, 3)), rng.uniform(1, 8, (5, 3)),
                           rng.uniform(-1.5, 1.5, (5, 1))], 1).astype(np.float32)
    _same_boxes(tp2n.obb_proposals_to_ngp(obbs, params),
                jp2n.obb_proposals_to_ngp(obbs, params))


@pytest.mark.parametrize("bbox_format", ["aabb", "obb"])
def test_process_scene_writes_the_same_json(tmp_path, bbox_format):
    rng = np.random.default_rng(2)
    np.savez(tmp_path / "s.npz", **_scene_params())
    n = 40
    props = (np.concatenate([rng.uniform(2, 12, (n, 3)), rng.uniform(14, 24, (n, 3))], 1)
             if bbox_format == "aabb" else
             np.concatenate([rng.uniform(4, 28, (n, 3)), rng.uniform(1, 8, (n, 3)),
                             rng.uniform(-1.5, 1.5, (n, 1))], 1)).astype(np.float32)
    np.savez(tmp_path / "props.npz", proposal=props,
             score=rng.uniform(0, 1, n).astype(np.float32))
    (tmp_path / "transforms.json").write_text(json.dumps({"frames": [], "aabb_scale": 2}))
    outs = {}
    for name, mod in (("jax", jp2n), ("port", tp2n)):
        outs[name] = mod.process_scene(tmp_path / "props.npz", tmp_path / "transforms.json",
                                       tmp_path / "s.npz", tmp_path / f"{name}.json",
                                       bbox_format=bbox_format, threshold=0.5, top_k=10)
    assert outs["port"] == outs["jax"] > 0
    _same_file(tmp_path / "port.json", tmp_path / "jax.json")


def test_proposals2ngp_main(tmp_path):
    rng = np.random.default_rng(3)
    for sub in ("props", "feats", "out_jax", "out_port"):
        (tmp_path / sub).mkdir()
    for scene in ("a", "b"):
        np.savez(tmp_path / "feats" / f"{scene}.npz", **_scene_params())
        np.savez(tmp_path / "props" / f"{scene}.npz",
                 proposal=np.concatenate([rng.uniform(2, 12, (8, 3)),
                                          rng.uniform(14, 24, (8, 3))], 1).astype(np.float32),
                 score=rng.uniform(0, 1, 8).astype(np.float32))
        (tmp_path / scene / "train").mkdir(parents=True)
        (tmp_path / scene / "train" / "transforms.json").write_text('{"frames": []}')
    for name, mod in (("jax", jp2n), ("port", tp2n)):
        mod.main(["--bbox_format", "aabb", "--dataset", "front3d", "--dataset_path",
                  str(tmp_path), "--features_path", str(tmp_path / "feats"),
                  "--proposals_path", str(tmp_path / "props"),
                  "--output_dir", str(tmp_path / f"out_{name}"), "--threshold", "0.2"])
    for scene in ("a", "b"):
        _same_file(tmp_path / "out_port" / f"{scene}.json",
                   tmp_path / "out_jax" / f"{scene}.json")


def test_obb_corners_and_write_ply(tmp_path):
    rng = np.random.default_rng(4)
    obbs = np.concatenate([rng.uniform(4, 28, (6, 3)), rng.uniform(1, 8, (6, 3)),
                           rng.uniform(-1.5, 1.5, (6, 1))], 1).astype(np.float32)
    corners = [tvis.obb_corners(b) for b in obbs]
    for got, b in zip(corners, obbs):
        _close(got, jvis.obb_corners(b))
    aabb = np.array([0, 0, 0, 1, 1, 1], np.float32)
    np.testing.assert_array_equal(tvis.aabb_corners(aabb), jvis.aabb_corners(aabb))
    pts = rng.uniform(0, 10, (20, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (20, 3)).astype(np.uint8)
    boxes = [jvis.obb_corners(b) for b in obbs] + [jvis.aabb_corners(aabb)]
    for with_colors in (True, False):
        c = colors if with_colors else None
        jvis.write_ply(str(tmp_path / "jax.ply"), pts, c, boxes)
        tvis.write_ply(str(tmp_path / "port.ply"), pts, c, boxes)
        _same_file(tmp_path / "port.ply", tmp_path / "jax.ply")
    np.testing.assert_array_equal(tvis._turbo_colormap(np.linspace(-0.5, 1.5, 50)),
                                  jvis._turbo_colormap(np.linspace(-0.5, 1.5, 50)))


@pytest.mark.parametrize("box_format,density_type,transpose",
                         [("aabb", "ngp", False), ("obb", "relu", True)])
def test_visualize_scene(tmp_path, box_format, density_type, transpose):
    rng = np.random.default_rng(5)
    vol = rng.uniform(0, 0.2, (16, 16, 16, 4)).astype(np.float32)
    vol[4:12, 3:10, 5:14] = [0.9, 0.2, 0.1, 50.0]
    np.savez(tmp_path / "sc.npz", rgbsigma=vol)
    boxes = (np.array([[4, 3, 5, 12, 10, 14], [1, 1, 1, 3, 4, 5]], np.float32)
             if box_format == "aabb" else
             np.array([[8, 6.5, 9.5, 8, 7, 9, 0.4], [3, 3, 3, 2, 3, 2, -1.2]], np.float32))
    np.save(tmp_path / "sc.npy", boxes)
    (tmp_path / "scores").mkdir()
    np.savez(tmp_path / "scores" / "sc.npz",
             **{"0": rng.normal(size=(4, 4, 4)).astype(np.float32),
                "1": rng.normal(size=(2, 2, 2)).astype(np.float32)})
    for name, mod in (("jax", jvis), ("port", tvis)):
        mod.visualize_scene("sc", str(tmp_path / name), str(tmp_path), str(tmp_path),
                            box_format, str(tmp_path / "scores"), 0.05, transpose,
                            density_type)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == ["sc.ply", "sc_objectness_0.ply", "sc_objectness_1.ply"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == files
    for f in files:
        _same_file(tmp_path / "port" / f, tmp_path / "jax" / f)


def test_heatmap_parts():
    rng = np.random.default_rng(6)
    vol = np.zeros((9, 9, 9), np.float32)
    vol[4, 4, 4] = 1.0
    sm = theat.gaussian_filter_3d(vol, 1.0)
    _close(sm, jheat.gaussian_filter_3d(vol, 1.0))
    np.testing.assert_allclose(sm.sum(), 1.0, rtol=1e-3)
    _close(theat.gaussian_kernel_1d(1.5, 4), jheat.gaussian_kernel_1d(1.5, 4))
    levels = {"0": rng.normal(size=(8, 8, 8)).astype(np.float32),
              "1": rng.normal(size=(4, 4, 4)).astype(np.float32)}
    combined = theat.combine_levels(_Npz(levels), (30, 32, 28))
    np.testing.assert_array_equal(combined, jheat.combine_levels(_Npz(levels), (30, 32, 28)))
    for axis in (0, 2):
        np.testing.assert_array_equal(theat.composite_heatmap(combined, axis),
                                      jheat.composite_heatmap(combined, axis))


class _Npz(dict):
    """The ``files`` / item access of an ``np.load`` of an npz."""

    @property
    def files(self):
        return list(self)


@pytest.mark.parametrize("grid_shape,export_ply", [((32, 32, 32), True), (None, False)])
def test_render_scene_and_main(tmp_path, grid_shape, export_ply):
    s0 = np.zeros((8, 8, 8), np.float32)
    s0[4, 4, 4] = 1.0
    s0[1, 6, 2] = 0.5
    np.savez(tmp_path / "hm.npz", **{"0": s0, "1": np.zeros((4, 4, 4), np.float32)})
    for name, mod in (("jax", jheat), ("port", theat)):
        mod.render_scene("hm", str(tmp_path), str(tmp_path / name), grid_shape=grid_shape,
                         sigma=1.0, export_ply=export_ply)
        mod.main(["--scores_dir", str(tmp_path), "--output_dir", str(tmp_path / f"{name}_main"),
                  "--axis", "1", "--export_ply"])
    names = ["hm_heatmap.png"] + (["hm_heatmap.ply"] if export_ply else [])
    for name in names:
        _same_file(tmp_path / "port" / name, tmp_path / "jax" / name)
    for name in ("hm_heatmap.png", "hm_heatmap.ply"):
        _same_file(tmp_path / "port_main" / name, tmp_path / "jax_main" / name)


def test_bbox_projection():
    frame = {"transform_matrix": np.eye(4).tolist(), "fy": 240.0, "fx": 240.0}
    h, w = 480, 640
    world2proj = tbbox.get_world_to_proj_matrix(frame, w, h)
    _close(world2proj, jbbox.get_world_to_proj_matrix(frame, w, h))
    rng = np.random.default_rng(7)
    pts = np.concatenate([rng.uniform(-1, 1, (30, 2)), rng.uniform(-4, 2, (30, 1))], 1)
    np.testing.assert_array_equal(tbbox.project_points(world2proj, pts),
                                  jbbox.project_points(world2proj, pts))
    obb = [0.0, 0.0, -2.0, 0.6, 0.6, 0.6, 0.3]
    _close(tbbox.get_obb_corners(obb), jbbox.get_obb_corners(obb))
    np.testing.assert_array_equal(tbbox.get_aabb_corners([-1, -1, -3], [1, 1, -2]),
                                  jbbox.get_aabb_corners([-1, -1, -3], [1, 1, -2]))
    corners = jbbox.get_obb_corners(obb)
    imgs = [np.zeros((h, w, 3), np.uint8) for _ in range(2)]
    tbbox.render_bbox_overlay(imgs[0], world2proj, corners, color=(255, 0, 0))
    jbbox.render_bbox_overlay(imgs[1], world2proj, corners, color=(255, 0, 0))
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert imgs[0][..., 0].sum() > 50 * 255
    assert tbbox.label_anchor(imgs[0].shape, world2proj, corners) == jbbox.label_anchor(
        imgs[1].shape, world2proj, corners)
    small = [np.zeros((8, 8, 3), np.uint8) for _ in range(2)]
    tbbox.draw_line(small[0], (-5.0, -5.0), (20.0, 20.0), (0, 255, 0))
    jbbox.draw_line(small[1], (-5.0, -5.0), (20.0, 20.0), (0, 255, 0))
    np.testing.assert_array_equal(small[0], small[1])


@pytest.mark.parametrize("pil", [True, False], ids=["pil", "no_pil"])
def test_visualize_bbox_process_scene(tmp_path, monkeypatch, pil):
    """With PIL the frame is read and labels drawn; without it (the GPU
    machine has none) both draw on JAX's blank 480 x 640 canvas."""
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)
    else:
        from PIL import Image

        (tmp_path / "images").mkdir()
        Image.fromarray(np.full((120, 160, 3), 40, np.uint8)).save(tmp_path / "images" / "0.png")
    frame = {"transform_matrix": np.eye(4).tolist(), "fy": 240.0, "fx": 240.0,
             "file_path": "images/0.png"}
    instances = {"instances": [
        {"label": "chair", "min_pt": [-0.25, -0.25, -2.25], "max_pt": [0.25, 0.25, -1.75],
         "obb": [0.0, 0.0, -2.0, 0.5, 0.5, 0.5, 0.0]},
        {"label": "table", "min_pt": [-0.4, -0.4, -2.4],
         "max_pt": [0.4, 0.4, -1.6], "obb": [0, 0, -2.0, 0.8, 0.8, 0.8, 0]},
    ]}
    for box_key in ("obb", "aabb"):
        written = {}
        for name, mod in (("jax", jbbox), ("port", tbbox)):
            written[name] = mod.process_scene(instances, {"frames": [frame]}, str(tmp_path),
                                              str(tmp_path / f"{name}_{box_key}"),
                                              box_key=box_key)
        assert [p.rsplit("/", 1)[1] for p in written["port"]] == ["0.png"]
        _same_file(written["port"][0], written["jax"][0])
        if not pil:
            assert tbbox._load_image(str(tmp_path / "images" / "0.png")).shape == (480, 640, 3)
