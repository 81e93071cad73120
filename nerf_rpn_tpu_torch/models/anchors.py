"""3D anchor generation — precomputed constants per (grid shape, stride).

Parity target: reference ``AnchorGenerator3D`` (``model/anchor.py:14-174``):
per-level base anchors are (unique permutations of each aspect-ratio triple)
x (sizes), rounded to integer half-extents; grid anchors sit at
``index * stride`` offsets (not voxel centers).  Default config
(``run_rpn.py:32-35``): sizes ((8,),(16,),(32,),(64,)), 5 ratio triples
-> 13 anchors/location at every level.

TPU re-design: anchors are *trace-time constants* — for static padded grid
shapes the whole anchor tensor is baked into the compiled program as numpy,
so there is zero step-time anchor computation.  Padding validity masks
(reference ``anchor.py:124-152``) become boolean numpy constants per
(level shape, original size) too.

Deviation noted for weight conversion: the reference dedups ratio
permutations via python ``set`` (CPython hash order); we use insertion-order
dedup, which is deterministic across runs.  The anchor *set* is identical;
only the per-location channel order may differ, which matters only when
importing reference-trained head weights (handled by the converter).
"""

from __future__ import annotations

from functools import lru_cache
from itertools import permutations
from typing import Sequence

import numpy as np

DEFAULT_ANCHOR_SIZES = ((8.0,), (16.0,), (32.0,), (64.0,))
DEFAULT_ASPECT_RATIOS = (
    ((1.0, 1.0, 1.0), (1.0, 1.0, 2.0), (1.0, 2.0, 2.0), (1.0, 1.0, 3.0), (1.0, 3.0, 3.0)),
) * 4


def _unique_permutations(ratio: Sequence[float]) -> list[tuple[float, ...]]:
    return list(dict.fromkeys(permutations(ratio)))


def base_anchors(
    sizes: Sequence[float],
    ratios: Sequence[Sequence[float]],
    normalize: bool = False,
) -> np.ndarray:
    """(A, 6) zero-centred AABB anchors for one level, rounded like the
    reference (``anchor.py:59-68``)."""
    # reference ordering: all ratio-permutations concatenated, then
    # (ratios[:, None] * scales[None, :]).view(-1) — scales fastest
    perms = np.concatenate(
        [np.array(_unique_permutations(r), np.float64) for r in ratios], axis=0
    )  # (P_total, 3)
    if normalize:
        weights = np.concatenate(
            [
                np.full(len(_unique_permutations(r)), np.prod(r) ** (1.0 / 3.0))
                for r in ratios
            ]
        )
        perms = perms / weights[:, None]
    scales = np.asarray(sizes, np.float64)
    dims = (perms[:, None, :] * scales[None, :, None]).reshape(-1, 3)
    half = dims / 2.0
    anchors = np.concatenate([-half, half], axis=1)
    return np.round(anchors).astype(np.float32)


def anchors_per_level(
    sizes: Sequence[float],
    ratios: Sequence[Sequence[float]],
) -> int:
    """A = len(sizes) * #unique permutations (13 for the default config)."""
    uniq = set()
    for r in ratios:
        uniq.update(permutations(r))
    return len(sizes) * len(uniq)


@lru_cache(maxsize=None)
def grid_anchors(
    grid_size: tuple[int, int, int],
    stride: tuple[int, int, int],
    sizes: tuple[float, ...],
    ratios: tuple[tuple[float, ...], ...],
    normalize: bool = False,
) -> np.ndarray:
    """All anchors for one FPN level: (gx * gy * gz * A, 6) float32.

    Anchor centres are at ``index * stride`` (reference convention,
    ``anchor.py:105-121``); flattening order is (x, y, z, anchor).
    """
    base = base_anchors(sizes, ratios, normalize)  # (A, 6)
    gx, gy, gz = grid_size
    sx = np.arange(gx, dtype=np.float32) * stride[0]
    sy = np.arange(gy, dtype=np.float32) * stride[1]
    sz = np.arange(gz, dtype=np.float32) * stride[2]
    mx, my, mz = np.meshgrid(sx, sy, sz, indexing="ij")
    shifts = np.stack([mx, my, mz, mx, my, mz], axis=-1).reshape(-1, 1, 6)
    return (shifts + base[None, None]).reshape(-1, 6).astype(np.float32)


def level_strides(
    mesh_size: Sequence[int], level_shapes: Sequence[Sequence[int]]
) -> list[tuple[int, int, int]]:
    """Integer strides per level, reference-style floor division
    (``anchor.py:162-165``)."""
    return [
        tuple(int(m // g) for m, g in zip(mesh_size, shape))
        for shape in level_shapes
    ]


def padding_valid_mask(
    grid_size: tuple[int, int, int],
    stride: tuple[int, int, int],
    ori_size: tuple[int, int, int],
    num_anchors: int,
) -> np.ndarray:
    """(gx * gy * gz * A,) bool — anchors whose cell lies inside the
    un-padded region of the scene (reference ``anchor.py:124-152``)."""
    limits = [int(np.ceil(o / s)) for o, s in zip(ori_size, stride)]
    gx, gy, gz = grid_size
    vx = np.arange(gx) < limits[0]
    vy = np.arange(gy) < limits[1]
    vz = np.arange(gz) < limits[2]
    grid = vx[:, None, None] & vy[None, :, None] & vz[None, None, :]
    return np.repeat(grid.reshape(-1), num_anchors)
