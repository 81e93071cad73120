"""rgbsigma voxel-grid datasets + TPU-shaped batching.

Parity targets (reference ``nerf_rpn/datasets.py``):
- ``load_scene``: ``{scene}.npz['rgbsigma']`` of shape (W, L, H, C), uint8
  scaled to [0, 1] (:55-61), optional density->alpha with the instant-ngp
  formula ``clip(1 - exp(-exp(sigma) / 100), 0, 1)`` (:165-167) or the
  ScanNet ReLU variant ``clip(1 - exp(-relu(sigma) / 100), 0, 1)``
  (:227-231).
- Scene filtering: drop scenes with missing feature files or zero boxes
  (:74-89).
- Dataset classes Front3D / Hypersim / ScanNet / General-CSV (``'None'``
  boxes sentinel) (:182-267) and ``split_dataset`` (:270-288).

TPU re-design: grids stay channels-LAST (W, L, H, C) — the model layout —
and batching pads every scene of a batch to a shared bucket shape (multiples
of ``pad_multiple``) with zero fill, emitting original sizes and padded gt
boxes + masks so the whole downstream pipeline is static-shape.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from nerf_rpn_tpu_torch.data.augment import augment_rpn_inputs


def density_to_alpha_ngp(density: np.ndarray) -> np.ndarray:
    """instant-ngp: sigma stored pre-activation (exp)."""
    return np.clip(1.0 - np.exp(-np.exp(density) / 100.0), 0.0, 1.0)


def density_to_alpha_relu(density: np.ndarray) -> np.ndarray:
    """dense-depth-priors NeRF (ScanNet): ReLU activation."""
    return np.clip(1.0 - np.exp(-np.clip(density, 0, None) / 100.0), 0.0, 1.0)


def load_scene(
    features_file: str,
    boxes_file: str | None,
    normalize_density: bool = True,
    alpha_fn=density_to_alpha_ngp,
):
    """Returns (rgbsigma (W, L, H, C) float32, boxes (N, 6|7) float32 | None)."""
    with np.load(features_file) as feats:
        rgbsigma = feats["rgbsigma"]
        if rgbsigma.dtype == np.uint8:
            rgbsigma = rgbsigma.astype(np.float32) / 255.0
        else:
            rgbsigma = rgbsigma.astype(np.float32)
        if normalize_density:
            rgbsigma[..., -1] = alpha_fn(rgbsigma[..., -1])
    boxes = None
    if boxes_file is not None:
        boxes = np.load(boxes_file).astype(np.float32)
    return rgbsigma, boxes


@dataclasses.dataclass
class SceneRecord:
    name: str
    features_file: str
    boxes_file: str | None


class _ItemRNG:
    """Deterministic per-access augmentation rng streams.

    ``rng(idx)`` returns a fresh ``np.random.Generator`` seeded by
    ``(seed, idx, k)`` where ``k`` counts accesses of that item.  Unlike one
    shared Generator, this is safe under threaded sample loading
    (``batch_iterator(num_workers=...)``) AND the stream each access sees is
    independent of worker count and thread completion order — the k-th load
    of scene ``idx`` always augments identically.
    """

    def __init__(self, seed: int):
        self.seed = seed
        self._lock = threading.Lock()
        self._access: dict[int, int] = {}

    def __call__(self, idx: int) -> np.random.Generator:
        with self._lock:
            k = self._access.get(idx, 0)
            self._access[idx] = k + 1
        return np.random.default_rng((self.seed, idx, k))


class BaseRPNDataset:
    """Indexable scene dataset with optional preload + augmentation."""

    alpha_fn = staticmethod(density_to_alpha_ngp)

    def __init__(
        self,
        features_path: str,
        boxes_path: str | None,
        scene_list: Optional[Sequence[str]] = None,
        normalize_density: bool = True,
        flip_prob: float = 0.0,
        rotate_prob: float = 0.0,
        rot_scale_prob: float = 0.0,
        preload: bool = False,
        seed: int = 0,
    ):
        self.normalize_density = normalize_density
        self.flip_prob = flip_prob
        self.rotate_prob = rotate_prob
        self.rot_scale_prob = rot_scale_prob
        self.rng = _ItemRNG(seed)

        if scene_list is None:
            scene_list = sorted(
                f[: -len(".npz")]
                for f in os.listdir(features_path)
                if f.endswith(".npz")
            )
        self.records: list[SceneRecord] = []
        for scene in scene_list:
            ff = os.path.join(features_path, scene + ".npz")
            if not os.path.isfile(ff):
                print(f"{scene} does not have a feature file")
                continue
            bf = None
            if boxes_path is not None:
                bf = os.path.join(boxes_path, scene + ".npy")
                if np.load(bf).shape[0] == 0:
                    print(f"{scene} does not have any boxes")
                    continue
            self.records.append(SceneRecord(scene, ff, bf))

        self._cache = None
        if preload:
            self._cache = [self._load(r) for r in self.records]

    def _load(self, rec: SceneRecord):
        return load_scene(
            rec.features_file, rec.boxes_file, self.normalize_density, self.alpha_fn
        )

    def __len__(self):
        return len(self.records)

    @property
    def scene_names(self):
        return [r.name for r in self.records]

    def __getitem__(self, idx: int):
        if self._cache is not None:
            rgbsigma, boxes = self._cache[idx]
        else:
            rgbsigma, boxes = self._load(self.records[idx])
        if self.flip_prob > 0 or self.rotate_prob > 0 or self.rot_scale_prob > 0:
            rgbsigma, boxes = augment_rpn_inputs(
                rgbsigma, boxes, self.rng(idx),
                self.flip_prob, self.rotate_prob, self.rot_scale_prob,
            )
        return rgbsigma, boxes, self.records[idx].name


class Front3DRPNDataset(BaseRPNDataset):
    pass


class HypersimRPNDataset(BaseRPNDataset):
    pass


class ScanNetRPNDataset(BaseRPNDataset):
    """ScanNet: features are z-up, always preloaded, ReLU-activation alpha."""

    alpha_fn = staticmethod(density_to_alpha_relu)

    def __init__(self, scene_list, features_path, boxes_path, **kw):
        kw.setdefault("preload", True)
        kw.setdefault("normalize_density", True)
        super().__init__(features_path, boxes_path, scene_list, **kw)


class GeneralRPNDataset(BaseRPNDataset):
    """CSV with columns scene,rgbsigma_path,boxes_path; 'None' = no GT."""

    def __init__(self, csv_path: str, normalize_density: bool = True, **kw):
        self.normalize_density = normalize_density
        self.flip_prob = kw.get("flip_prob", 0.0)
        self.rotate_prob = kw.get("rotate_prob", 0.0)
        self.rot_scale_prob = kw.get("rot_scale_prob", 0.0)
        self.rng = _ItemRNG(kw.get("seed", 0))
        self.records = []
        with open(csv_path, newline="") as f:
            for row in csv.DictReader(f):
                bf = None if row["boxes_path"] == "None" else row["boxes_path"]
                assert os.path.isfile(row["rgbsigma_path"]), row["rgbsigma_path"]
                if bf is not None:
                    assert os.path.isfile(bf), bf
                self.records.append(SceneRecord(row["scene"], row["rgbsigma_path"], bf))
        self._cache = [self._load(r) for r in self.records]


def split_dataset(scenes: Sequence[str], train_ratio: float, val_ratio: float,
                  output_file: str, seed: int = 0):
    """Shuffle + split scene names, save npz with {train,val,test}_scenes
    (reference ``split_hypersim_dataset``, ``datasets.py:270-288``)."""
    assert train_ratio + val_ratio <= 1.0
    scenes = list(scenes)
    np.random.default_rng(seed).shuffle(scenes)
    n_train = int(len(scenes) * train_ratio)
    n_val = int(len(scenes) * (train_ratio + val_ratio))
    np.savez(
        output_file,
        train_scenes=np.array(scenes[:n_train]),
        val_scenes=np.array(scenes[n_train:n_val]),
        test_scenes=np.array(scenes[n_val:]),
    )


def load_split(split_file: str):
    with np.load(split_file) as f:
        return (
            [str(s) for s in f["train_scenes"]],
            [str(s) for s in f["val_scenes"]],
            [str(s) for s in f["test_scenes"]],
        )


class RPNClassificationDataset:
    """Stage-2 dataset: saved FPN level features + RPN proposals per scene
    (reference ``RPNClassificationDataset``, ``datasets.py:332-496``).

    Each item -> (features: list of per-level (X, Y, Z, C) arrays | raw
    rgbsigma in fine_tune mode, boxes (G, D), rois (R, D), roi_levels (R,),
    scene).  fine_tune mode drops RoIs covering > 50% of the scene volume
    (``datasets.py:386-392``).  The RoI files hold ``proposals`` (``run_rpn
    --save_results``) or, as ``run_fcos --output_proposals
    --save_level_index`` writes them, ``proposal``; the JAX package's copy
    reads only ``proposals`` and raises ``KeyError`` on FCOS files.
    """

    def __init__(self, features_path: str, boxes_path: str, roi_path: str,
                 scene_names: Optional[Sequence[str]] = None,
                 fine_tune: bool = False, normalize_density: bool = True,
                 flip_prob: float = 0.0, rotate_prob: float = 0.0,
                 rot_scale_prob: float = 0.0, seed: int = 0):
        self.fine_tune = fine_tune
        self.flip_prob = flip_prob
        self.rotate_prob = rotate_prob
        self.rot_scale_prob = rot_scale_prob
        self.rng = _ItemRNG(seed)
        if scene_names is None:
            scene_names = sorted(
                f[: -len(".npz")]
                for f in os.listdir(features_path)
                if f.endswith(".npz")
            )
        self.scene_data = []
        for scene in scene_names:
            bf = os.path.join(boxes_path, scene + ".npy")
            rf = os.path.join(roi_path, scene + ".npz")
            ff = os.path.join(features_path, scene + ".npz")
            if not (os.path.isfile(bf) and os.path.isfile(rf) and os.path.isfile(ff)):
                print(f"{scene} does not have a training file")
                continue
            with np.load(ff, allow_pickle=True) as feats:
                if fine_tune:
                    rgbsigma = feats["rgbsigma"].astype(np.float32)
                    if normalize_density:
                        rgbsigma[..., -1] = density_to_alpha_ngp(rgbsigma[..., -1])
                    features = rgbsigma  # (W, L, H, C)
                    resolution = rgbsigma.shape[:3]
                else:
                    resolution = feats["resolution"]
                    level_feats = feats["level_features"]
                    features = []
                    for i in range(len(level_feats)):
                        arr = level_feats[i].reshape(resolution[i]).astype(np.float32)
                        # saved layout is (C, X, Y, Z) (reference dump);
                        # convert to this framework's channels-last
                        features.append(np.moveaxis(arr, 0, -1))
            boxes = np.load(bf).astype(np.float32)
            with np.load(rf, allow_pickle=True) as f_roi:
                key = "proposals" if "proposals" in f_roi.files else "proposal"
                proposals = f_roi[key].astype(np.float32)
                levels = f_roi["level_indices"].astype(np.int32)
            if fine_tune:
                world_vol = float(np.prod(resolution[:3]))
                vol = proposals[:, 3] * proposals[:, 4] * proposals[:, 5]
                keep = vol / world_vol <= 0.5
                proposals, levels = proposals[keep], levels[keep]
            self.scene_data.append((scene, features, boxes, proposals, levels))

    def __len__(self):
        return len(self.scene_data)

    @property
    def scene_names(self):
        return [s[0] for s in self.scene_data]

    def __getitem__(self, idx):
        scene, features, boxes, proposals, levels = self.scene_data[idx]
        if self.fine_tune and (
            self.flip_prob > 0 or self.rotate_prob > 0 or self.rot_scale_prob > 0
        ):
            # fine-tune augmentation (reference ``datasets.py:410-426``):
            # augment the raw grid and (gt U rois) JOINTLY with the stage-1
            # transform, then split back; level indices are untouched.
            n_gt = boxes.shape[0]
            joint = np.concatenate([boxes, proposals], axis=0)
            features, joint = augment_rpn_inputs(
                features, joint, self.rng(idx),
                self.flip_prob, self.rotate_prob, self.rot_scale_prob,
            )
            boxes, proposals = joint[:n_gt], joint[n_gt:]
        return features, boxes, proposals, levels, scene


def collate_classification_batch(
    samples: Sequence[tuple],
    max_rois: int = 1024,
    max_gt: int = 64,
    box_dim: int = 6,
    level_pad_multiple: int = 8,
):
    """Pad a stage-2 batch to static shapes.

    Returns dict: features (list of (B, X_l, Y_l, Z_l, C)), rois
    (B, R, box_dim), roi_levels (B, R) int32, roi_valid (B, R), gt_boxes,
    gt_mask, names.
    """
    b = len(samples)
    fine_tune = isinstance(samples[0][0], np.ndarray)
    if fine_tune:
        # raw rgbsigma grids -> one padded (B, X, Y, Z, C) array
        shapes = np.array([s[0].shape[:3] for s in samples])
        target = np.array(
            [round_up(int(m), level_pad_multiple) for m in shapes.max(0)]
        )
        c = samples[0][0].shape[-1]
        grids = np.zeros((b, *target, c), np.float32)
        for i, s in enumerate(samples):
            f = s[0]
            grids[i, : f.shape[0], : f.shape[1], : f.shape[2]] = f
        feats_out = None
    else:
        n_levels = len(samples[0][0])
        feats_out = []
        for lvl in range(n_levels):
            shapes = np.array([s[0][lvl].shape[:3] for s in samples])
            target = np.array(
                [round_up(int(m), level_pad_multiple) for m in shapes.max(0)]
            )
            c = samples[0][0][lvl].shape[-1]
            buf = np.zeros((b, *target, c), np.float32)
            for i, s in enumerate(samples):
                f = s[0][lvl]
                buf[i, : f.shape[0], : f.shape[1], : f.shape[2]] = f
            feats_out.append(buf)

    rois = np.zeros((b, max_rois, box_dim), np.float32)
    roi_levels = np.zeros((b, max_rois), np.int32)
    roi_valid = np.zeros((b, max_rois), bool)
    gt = np.zeros((b, max_gt, box_dim), np.float32)
    gt_mask = np.zeros((b, max_gt), bool)
    names = []
    for i, (feats, boxes, proposals, levels, name) in enumerate(samples):
        r = min(len(proposals), max_rois)
        rois[i, :r] = proposals[:r, :box_dim]
        roi_levels[i, :r] = levels[:r]
        roi_valid[i, :r] = True
        g = min(len(boxes), max_gt)
        gt[i, :g] = boxes[:g, :box_dim]
        gt_mask[i, :g] = True
        names.append(name)
    # per-scene UNPADDED level-0 feature shape (raw grid shape in fine-tune);
    # x spatial_scale[0] this is the reference's eval-time "mesh size" for
    # stage-2 proposal filtering (run_rpn_detect.py:495-496)
    feat_shapes = np.array(
        [(s[0] if fine_tune else s[0][0]).shape[:3] for s in samples],
        np.int32,
    )
    out = {
        "rois": rois,
        "roi_levels": roi_levels,
        "roi_valid": roi_valid,
        "gt_boxes": gt,
        "gt_mask": gt_mask,
        "feat_shapes": feat_shapes,
        "names": names,
    }
    if fine_tune:
        out["grids"] = grids
    else:
        out["features"] = feats_out
    return out


# ---------------------------------------------------------------------------
# TPU batching: bucketed padding + masks
# ---------------------------------------------------------------------------


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def collate_batch(
    samples: Sequence[tuple],
    pad_multiple: int = 32,
    max_gt: int = 64,
    box_dim: int = 6,
    fixed_shape: Sequence[int] | None = None,
    grid_dtype=np.float32,
):
    """Pad a list of (rgbsigma, boxes, name) to one static-shape batch.

    Returns dict of numpy arrays:
      grids (B, X, Y, Z, C) zero-padded; ori_sizes (B, 3) int32;
      gt_boxes (B, max_gt, box_dim); gt_mask (B, max_gt); names list.

    Bucketing to ``pad_multiple`` keeps the number of distinct compiled
    shapes small (SURVEY 5.7: pad grids to a small set of bucketed shapes).

    ``grid_dtype``: bf16 models cast grids at their first conv anyway, so
    drivers pass ``ml_dtypes.bfloat16`` to do that cast HERE (same
    round-to-nearest-even values) — halving host->device transfer and the
    device-side read (embed unit ~0.45 ms/scene at the bench shape,
    benchmarks/microbench_embed_layout.py).
    """
    shapes = np.array([s[0].shape[:3] for s in samples])
    if fixed_shape is not None:
        target = np.asarray(fixed_shape)
    else:
        target = np.array([round_up(int(m), pad_multiple) for m in shapes.max(0)])
    b = len(samples)
    c = samples[0][0].shape[-1]
    grids = np.zeros((b, *target, c), grid_dtype)
    gt = np.zeros((b, max_gt, box_dim), np.float32)
    gt_mask = np.zeros((b, max_gt), bool)
    names = []
    for i, (vol, boxes, name) in enumerate(samples):
        w, l, h = vol.shape[:3]
        assert (target >= (w, l, h)).all(), (target, vol.shape)
        grids[i, :w, :l, :h] = vol
        if boxes is not None and len(boxes) > 0:
            n = min(len(boxes), max_gt)
            gt[i, :n] = boxes[:n, :box_dim]
            gt_mask[i, :n] = True
        names.append(name)
    return {
        "grids": grids,
        "ori_sizes": shapes.astype(np.int32),
        "gt_boxes": gt,
        "gt_mask": gt_mask,
        "names": names,
    }


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    process_index: int = 0,
    process_count: int = 1,
    num_workers: int = 0,
    pad_last: bool = False,
    collate=None,
    index_batches=None,
    **collate_kw,
):
    """Host-side batch loader with per-process sharding (the reference's
    ``DistributedSampler`` equivalent, keyed on process index).

    ``pad_last`` fills a ragged last batch up to ``batch_size`` with its
    last sample (an eval batch of a fixed size); ``collate(samples)``
    replaces ``collate_batch(samples, **collate_kw)``; ``index_batches``,
    the dataset indices of each batch, replaces the order and batching that
    the other arguments give (a rank's eval blocks, ``ddp.eval_blocks``).

    ``num_workers > 0`` loads the samples of each batch over a thread pool
    (the reference's ``DataLoader(num_workers=4)`` analogue — npz
    decompression and the OBB rotation + scale's C++ resample,
    ``native.rotate_scale_resample``, release the GIL).  Batches and the
    samples within them keep their order; augmentation streams are
    per-(item, access) so results are bit-identical to the serial path
    (``_ItemRNG``).  Wrap the returned generator in
    ``data.loader.prefetch_iterator`` to additionally overlap whole-batch
    assembly with consumption.
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    if process_count > 1:
        # DistributedSampler semantics (torch's sampler pads every rank to
        # ceil(n/world) by wrapping the permutation): in a real multi-host
        # run every process must execute the SAME number of jitted
        # collective steps or the trailing psum deadlocks at epoch end.
        total = -(-len(order) // process_count) * process_count
        if total > len(order):
            order = np.concatenate([order, order[: total - len(order)]])
        order = order[process_index::process_count]
    if index_batches is None:
        index_batches = [order[start : start + batch_size]
                         for start in range(0, len(order), batch_size)]
    pool = ThreadPoolExecutor(num_workers) if num_workers > 0 else None
    try:
        for idx in index_batches:
            if drop_last and len(idx) < batch_size:
                return
            if pad_last and len(idx) < batch_size:
                idx = np.concatenate([idx, np.repeat(idx[-1:], batch_size - len(idx))])
            if pool is not None:
                samples = list(pool.map(dataset.__getitem__, map(int, idx)))
            else:
                samples = [dataset[int(i)] for i in idx]
            yield (collate_batch(samples, **collate_kw) if collate is None
                   else collate(samples))
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
