"""ScanNet scene preparation: sharp-frame sampling, pose validation, and the
ground-truth-pose-seeded COLMAP reconstruction pipeline.

Parity target: reference ``data/scannet/prepare_scannet.py`` (sharpest-frame
sampling per uniform chunk, pose validation, dense-depth-priors-NeRF scene
layout: ``train_set.csv``/``test_set.csv``/``config.json``/``colmap/``) and
``data/scannet/run_colmap.py`` (two-phase COLMAP SfM: all-image database +
gt-pose-seeded triangulation, z-up model transform, and a train-image-only
re-triangulation whose ``images.txt`` is rebuilt with the train database's
image ids).

All decision logic is pure and unit-testable: frame selection takes an
injectable sharpness function, COLMAP invocations are assembled as command
strings by ``sfm_commands``/``process_commands`` (subprocess execution is
gated on the ``colmap`` binary existing), and the gt-pose ``images.txt``
writer and train-set rebuild are plain functions over file contents.

Copy of ``nerf_rpn_tpu/datatools/prepare_scannet.py`` for the torch port, with the
same functions and CLI flags (``python -m
nerf_rpn_tpu_torch.datatools.prepare_scannet --help``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sqlite3
import subprocess

import numpy as np


# ---------------------------------------------------------------------------
# Frame selection (reference prepare_scannet.py:17-96)
# ---------------------------------------------------------------------------


def _load_gray(image_path: str) -> np.ndarray:
    try:
        from PIL import Image

        return np.asarray(Image.open(image_path).convert("L"), np.float32)
    except ImportError:
        pass
    try:
        import cv2

        return cv2.imread(image_path, cv2.IMREAD_GRAYSCALE).astype(np.float32)
    except ImportError as e:
        raise RuntimeError("need PIL or cv2 to score image sharpness") from e


def sharpness(image_path: str) -> float:
    """Variance of the Laplacian (reference ``prepare_scannet.sharpness``,
    ``prepare_scannet.py:17-21``; same 4-neighbour kernel as cv2.Laplacian,
    interior pixels only instead of cv2's reflected border)."""
    img = _load_gray(image_path)
    lap = (
        -4 * img
        + np.roll(img, 1, 0) + np.roll(img, -1, 0)
        + np.roll(img, 1, 1) + np.roll(img, -1, 1)
    )
    return float(lap[1:-1, 1:-1].var())


def validate_poses(img_idxs, pose_dir: str) -> list[int]:
    """Keep frames whose 4x4 pose matrix is fully finite (reference
    ``validate_pose``, ``prepare_scannet.py:24-34``; additionally treats a
    missing/garbled file as invalid instead of crashing)."""
    valid = []
    for idx in img_idxs:
        pose_file = os.path.join(pose_dir, f"{idx}.txt")
        if not os.path.isfile(pose_file):
            continue
        try:
            mat = np.loadtxt(pose_file)
        except ValueError:
            continue
        if mat.shape == (4, 4) and np.isfinite(mat).all():
            valid.append(idx)
    return valid


def sample_train_frames(frames, num_train: int, score_fn):
    """Sharpest frame of each of ``num_train`` uniform chunks.

    Reference chunking (``prepare_scannet.py:62-74``): ``interval = len //
    num_train``; chunk i is ``frames[i*interval:(i+1)*interval]`` — the tail
    ``len % num_train`` frames are never candidates.  Returns
    (train_idxs, scores dict over every scored frame).
    """
    scores: dict[int, float] = {}
    train: list[int] = []
    interval = len(frames) // num_train
    if interval == 0:
        # fewer frames than requested samples: every frame is its own chunk
        interval, num_train = 1, len(frames)
    for i in range(num_train):
        chunk = frames[i * interval:(i + 1) * interval]
        if not chunk:
            continue
        vals = [score_fn(x) for x in chunk]
        scores.update(zip(chunk, vals))
        train.append(chunk[int(np.argmax(vals))])
    return train, scores


def sample_val_frames(frames, train, scores, num_val: int, score_fn):
    """Sharpest non-train frame of each of ``num_val`` uniform chunks over
    the full frame list (reference ``prepare_scannet.py:76-85``); empty
    chunks are skipped.  Frames the train pass never scored (the tail the
    reference would KeyError on) are scored on demand via ``score_fn``."""
    taken = set(train)
    val: list[int] = []
    interval = len(frames) // num_val
    if interval == 0:
        interval, num_val = 1, len(frames)
    for i in range(num_val):
        chunk = [x for x in frames[i * interval:(i + 1) * interval]
                 if x not in taken]
        if not chunk:
            continue
        vals = [
            scores[x] if x in scores else score_fn(x)  # type: ignore[misc]
            for x in chunk
        ]
        val.append(chunk[int(np.argmax(vals))])
    return val


def prepare_scene(
    scene_path: str,
    output_path: str,
    num_train_samples: int = 100,
    num_val_samples: int = 20,
    min_valid_frames: int = 2000,
    score_fn=None,
):
    """Select views and lay out one scene (reference
    ``prepare_scannet_scene``, ``prepare_scannet.py:37-110``).

    Input layout: ``{scene_path}/extract/{color,intrinsic,pose}``.
    Output: ``train_set.csv`` / ``test_set.csv`` (one ``{idx}.jpg`` line per
    frame, no header), ``config.json`` and ``colmap/{sparse,sparse_train}``.
    Returns (train, val) or None when the scene has too few valid frames.
    """
    scene_name = os.path.basename(os.path.normpath(scene_path))
    out = os.path.join(output_path, scene_name)
    img_dir = os.path.join(scene_path, "extract", "color")
    pose_dir = os.path.join(scene_path, "extract", "pose")

    frames = sorted(
        int(f.split(".")[0]) for f in os.listdir(img_dir)
        if f.endswith(".jpg") and f.split(".")[0].isdigit()
    )
    frames = validate_poses(frames, pose_dir)
    if len(frames) < min_valid_frames:
        print(f"Warning: {scene_path} has less than {min_valid_frames} "
              "valid images")
        return None

    if score_fn is None:
        score_fn = lambda i: sharpness(os.path.join(img_dir, f"{i}.jpg"))
    train, scores = sample_train_frames(frames, num_train_samples, score_fn)
    val = sample_val_frames(frames, train, scores, num_val_samples, score_fn)

    os.makedirs(out, exist_ok=True)
    for name, idxs in (("train_set.csv", train), ("test_set.csv", val)):
        with open(os.path.join(out, name), "w") as f:
            f.writelines(f"{i}.jpg\n" for i in idxs)
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(
            {"name": scene_name, "max_depth": 15.0, "dist2m": 1.0,
             "rgb_only": True},
            f, indent=2,
        )
    os.makedirs(os.path.join(out, "colmap", "sparse"), exist_ok=True)
    os.makedirs(os.path.join(out, "colmap", "sparse_train"), exist_ok=True)
    return train, val


# ---------------------------------------------------------------------------
# Ground-truth pose seeding (reference run_colmap.py:29-92)
# ---------------------------------------------------------------------------


def rotmat_to_quat_wxyz(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0."""
    r = np.asarray(r, np.float64)
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                      (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(1.0 + r[i, i] - r[j, j] - r[k, k]) * 2
        q = np.empty(4)
        q[0] = (r[k, j] - r[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (r[j, i] + r[i, j]) / s
        q[1 + k] = (r[k, i] + r[i, k]) / s
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def pose_to_colmap_qt(pose: np.ndarray):
    """Camera-to-world 4x4 -> COLMAP world-to-camera (quat wxyz, translation)
    (reference ``write_ground_truth_poses``, ``run_colmap.py:78-82``:
    ``rot = pose[:3,:3].T``, ``trans = -rot @ pose[:3,3]``)."""
    pose = np.asarray(pose, np.float64)
    rot = pose[:3, :3].T
    trans = -rot @ pose[:3, 3]
    return rotmat_to_quat_wxyz(rot), trans


def read_fx_color(camera_params_path: str) -> float:
    """Parse ``fx_color`` from a ScanNet ``{scene}.txt`` camera-params file
    (reference ``run_colmap.py:33-37``)."""
    with open(camera_params_path) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "fx_color":
                return float(parts[2])
    raise ValueError(f"no fx_color in {camera_params_path}")


def write_ground_truth_poses(
    sparse_dir: str, db_path: str, pose_dir: str, camera_params_path: str
) -> None:
    """Seed a COLMAP sparse model with ground-truth poses (reference
    ``run_colmap.py:29-92``): empty ``points3D.txt``; rewrite the database's
    single SIMPLE_PINHOLE camera with fx_color/2 (half-resolution images);
    write ``cameras.txt`` and a gt ``images.txt`` (two lines per image, the
    second empty), then copy it to ``gt_poses.txt``."""
    with open(os.path.join(sparse_dir, "points3D.txt"), "w"):
        pass

    fx = read_fx_color(camera_params_path)
    db = sqlite3.connect(db_path)
    rows = list(db.execute("SELECT * FROM cameras"))
    assert len(rows) == 1, "expected a single-camera database"
    camera_id, model, width, height, params, prior = rows[0]
    params = np.frombuffer(params, np.float64).copy()
    assert model == 0 and params.shape == (3,), (model, params.shape)
    params[0] = fx / 2  # images are extracted at half resolution

    db.execute("DELETE FROM cameras")
    db.execute(
        "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
        (camera_id, model, width, height, params.tobytes(), prior),
    )
    db.commit()

    with open(os.path.join(sparse_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write("# Number of cameras: 1\n")
        f.write(f"{camera_id} SIMPLE_PINHOLE {width} {height} "
                f"{params[0]} {params[1]} {params[2]}\n")

    id2name = dict(db.execute("SELECT image_id, name FROM images"))
    db.close()
    with open(os.path.join(sparse_dir, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for img_id, name in id2name.items():
            pose = np.loadtxt(
                os.path.join(pose_dir, name.split(".")[0] + ".txt"))
            quat, trans = pose_to_colmap_qt(pose)
            f.write(f"{img_id} {quat[0]} {quat[1]} {quat[2]} {quat[3]} "
                    f"{trans[0]} {trans[1]} {trans[2]} 1 {name}\n\n")
    shutil.copyfile(os.path.join(sparse_dir, "images.txt"),
                    os.path.join(sparse_dir, "gt_poses.txt"))


def build_train_images_txt(in_lines, train_files, name2dbid) -> list[str]:
    """Rebuild ``images.txt`` for the train subset: keep comments, keep only
    train images, and replace each image id with its id in the train-image
    database (reference ``run_colmap.process``, ``run_colmap.py:222-239``).

    Each kept image line is followed by an EMPTY POINTS2D line: the COLMAP
    images.txt format is two lines per image and ``colmap
    point_triangulator`` reads line pairs (the reference writes
    ``" ".join(split_line) + "\\n"`` where the joined line already ends in
    ``\\n``, producing the same blank second line)."""
    out = []
    for line in in_lines:
        split_line = line.split(" ")
        if "#" in split_line[0]:
            out.append(line)
            continue
        for train_file in train_files:
            if " " + train_file in line:
                split_line[0] = str(name2dbid[train_file])
                out.append(" ".join(split_line).rstrip("\n") + "\n\n")
                break
    return out


# ---------------------------------------------------------------------------
# COLMAP command assembly (reference run_colmap.py:95-262)
# ---------------------------------------------------------------------------


def _gpu_suffix(flag: str, gpu_list) -> str:
    if not gpu_list:
        return ""
    return f" --{flag}.gpu_index={','.join(str(g) for g in gpu_list)}"


def sfm_commands(data_dir: str, gpu_list=None) -> dict[str, list[str]]:
    """All-image SfM commands (reference ``run_colmap_sfm``,
    ``run_colmap.py:95-137``): feature extraction + matching into
    ``recon/db_all.db``, then (after gt-pose seeding) triangulation, mapper,
    and TXT conversion on ``recon/sparse/0``."""
    rgb_all = os.path.join(data_dir, "images_all")
    recon = os.path.join(data_dir, "recon")
    db_all = os.path.join(recon, "db_all.db")
    sparse0 = os.path.join(recon, "sparse", "0")
    extract = (f"colmap feature_extractor  --database_path {db_all} "
               f"--image_path {rgb_all} --ImageReader.single_camera 1 "
               f"--ImageReader.camera_model SIMPLE_PINHOLE"
               + _gpu_suffix("SiftExtraction", gpu_list))
    match = (f"colmap exhaustive_matcher --database_path {db_all}  "
             f"--SiftMatching.guided_matching 1"
             + _gpu_suffix("SiftMatching", gpu_list))
    triangulate = (f"colmap point_triangulator --database_path {db_all} "
                   f"--image_path {rgb_all} --input_path {sparse0} "
                   f"--output_path {sparse0}")
    mapper = (f"colmap mapper --database_path {db_all} "
              f"--image_path {rgb_all} --input_path {sparse0} "
              f"--output_path {sparse0} --Mapper.multiple_model 0")
    convert = (f"colmap model_converter --input_path={sparse0} "
               f"--output_path={sparse0} --output_type=TXT")
    return {
        "database": [extract, match],
        "reconstruct": [triangulate, mapper, convert],
    }


def process_commands(data_dir: str, transform_path: str,
                     gpu_list=None) -> dict[str, list[str]]:
    """Post-SfM commands (reference ``process``, ``run_colmap.py:160-262``):
    z-up model transform, train-image feature extraction into ``recon/db.db``
    and (after the train images.txt rebuild) matching + triangulation + TXT
    conversion on ``recon/sparse_train/0``."""
    recon = os.path.join(data_dir, "recon")
    rgb_train = os.path.join(data_dir, "images_train")
    sparse0 = os.path.join(recon, "sparse", "0")
    zup = os.path.join(recon, "sparse_z_up", "0")
    db = os.path.join(recon, "db.db")
    constructed = os.path.join(recon, "constructed_sparse_train", "0")
    sparse_train = os.path.join(recon, "sparse_train", "0")
    return {
        "transform": [
            (f"colmap model_transformer --input_path={sparse0} "
             f"--output_path={zup} --transform_path={transform_path}"),
            (f"colmap model_converter --input_path={zup} "
             f"--output_path={zup} --output_type=TXT"),
        ],
        "train_extract": [
            (f"colmap feature_extractor  --database_path {db} "
             f"--image_path {rgb_train} --ImageReader.single_camera 1 "
             f"--ImageReader.camera_model SIMPLE_PINHOLE"
             + _gpu_suffix("SiftExtraction", gpu_list)),
        ],
        "train_reconstruct": [
            (f"colmap exhaustive_matcher --database_path {db}  "
             f"--SiftMatching.guided_matching 1"
             + _gpu_suffix("SiftMatching", gpu_list)),
            (f"colmap point_triangulator --database_path {db} "
             f"--image_path {rgb_train} --input_path {constructed} "
             f"--output_path {sparse_train}"),
            (f"colmap model_converter --input_path={sparse_train} "
             f"--output_path={sparse_train} --output_type=TXT"),
        ],
    }


def count_reconstructed_images(images_txt_path: str) -> int:
    """4 comment/header lines, 2 lines per reconstructed image (reference
    ``run_colmap.py:146-148``)."""
    with open(images_txt_path) as f:
        number_lines = sum(1 for _ in f)
    return (number_lines - 4) // 2


def _run(cmds, verbose=False):
    for cmd in cmds:
        if verbose:
            print("+", cmd)
        subprocess.run(cmd, shell=True, check=True,
                       stdout=None if verbose else subprocess.DEVNULL)


def run_colmap_sfm(scene_dir: str, data_dir: str, verbose=False,
                   gpu_list=None) -> bool:
    """Execute the all-image SfM phase (gt-pose seeded).  Requires the
    ``colmap`` binary; returns reconstruction completeness."""
    if shutil.which("colmap") is None:
        raise RuntimeError(
            "colmap binary not found; use sfm_commands() to run elsewhere")
    scene_name = os.path.basename(os.path.normpath(scene_dir))
    pose_dir = os.path.join(scene_dir, "extract", "pose")
    cam_params = os.path.join(scene_dir, f"{scene_name}.txt")
    recon = os.path.join(data_dir, "recon")
    if os.path.exists(recon):
        shutil.rmtree(recon)
    sparse0 = os.path.join(recon, "sparse", "0")
    os.makedirs(sparse0, exist_ok=True)
    cmds = sfm_commands(data_dir, gpu_list)
    _run(cmds["database"], verbose)
    write_ground_truth_poses(sparse0, os.path.join(recon, "db_all.db"),
                             pose_dir, cam_params)
    _run(cmds["reconstruct"], verbose)
    n_in = len(os.listdir(os.path.join(data_dir, "images_all")))
    n_out = count_reconstructed_images(os.path.join(sparse0, "images.txt"))
    return n_in == n_out


def run_colmap_process(data_dir: str, transform_path: str, verbose=False,
                       gpu_list=None) -> None:
    """Execute the post-SfM phase: z-up transform + train-subset
    re-triangulation with the rebuilt images.txt."""
    if shutil.which("colmap") is None:
        raise RuntimeError(
            "colmap binary not found; use process_commands() to run elsewhere")
    recon = os.path.join(data_dir, "recon")
    cmds = process_commands(data_dir, transform_path, gpu_list)
    zup = os.path.join(recon, "sparse_z_up", "0")
    os.makedirs(zup, exist_ok=True)
    _run(cmds["transform"], verbose)
    _run(cmds["train_extract"], verbose)

    constructed = os.path.join(recon, "constructed_sparse_train", "0")
    os.makedirs(constructed, exist_ok=True)
    shutil.copyfile(os.path.join(zup, "cameras.txt"),
                    os.path.join(constructed, "cameras.txt"))
    open(os.path.join(constructed, "points3D.txt"), "a").close()
    train_files = os.listdir(os.path.join(data_dir, "images_train"))
    cur = sqlite3.connect(os.path.join(recon, "db.db")).cursor()
    name2dbid = dict(cur.execute("SELECT name, image_id FROM images"))
    with open(os.path.join(zup, "images.txt")) as f:
        in_lines = f.readlines()
    with open(os.path.join(constructed, "images.txt"), "w") as f:
        f.writelines(build_train_images_txt(in_lines, train_files, name2dbid))
    os.makedirs(os.path.join(recon, "sparse_train", "0"), exist_ok=True)
    _run(cmds["train_reconstruct"], verbose)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Prepare ScanNet scenes for dense-depth-priors NeRF.")
    p.add_argument("--scannet_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--num_scenes", type=int, default=None)
    p.add_argument("--num_train_samples", type=int, default=100)
    p.add_argument("--num_val_samples", type=int, default=20)
    p.add_argument("--min_valid_frames", type=int, default=2000)
    args = p.parse_args(argv)

    scenes = sorted(
        d for d in os.listdir(args.scannet_path)
        if os.path.isdir(os.path.join(args.scannet_path, d))
    )
    if args.num_scenes:
        scenes = scenes[: args.num_scenes]
    for scene in scenes:
        result = prepare_scene(
            os.path.join(args.scannet_path, scene), args.output_path,
            args.num_train_samples, args.num_val_samples,
            args.min_valid_frames)
        if result is not None:
            train, val = result
            print(f"{scene}: {len(train)} train / {len(val)} val frames")


if __name__ == "__main__":
    main()
