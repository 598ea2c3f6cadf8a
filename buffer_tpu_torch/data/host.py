"""ctypes bindings of the native host point-cloud operations.

Counterpart of ``buffer_tpu/kernels/host.py``: grid subsampling, radius
neighbours, exact kNN, kNN-PCA normals and farthest point sampling.  The
library is built from the repository's ``cpp/host_ops.cpp`` (its C ABI,
``buffer_grid_subsample``, ``buffer_radius_neighbors``, ``buffer_knn``,
``buffer_normals``, ``buffer_fps``) into ``build/host/`` at first use, with
portable flags: ``cpp/Makefile`` builds for the building machine's own CPU
(``-march=native``), so a library built elsewhere is never loaded.  A
failed build raises; there is no numpy fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from buffer_tpu_torch.kernels.cuda import REPO_ROOT, NativeLib

_P, _I64, _I32, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_float
_HOST = NativeLib(
    "bufferhost", [REPO_ROOT / "cpp" / "host_ops.cpp"], "g++",
    ["-O3", "-std=c++17", "-fPIC", "-shared"], "host",
    {"buffer_grid_subsample": (ctypes.c_int, [_P, _I64, _F, _P, _I64]),
     "buffer_radius_neighbors": (None, [_P, _I64, _P, _I64, _F, _I32, _P, _P]),
     "buffer_knn": (None, [_P, _I64, _P, _I64, _F, _I32, _P, _P]),
     "buffer_normals": (None, [_P, _I64, _P, _P, _I32, _P]),
     "buffer_fps": (None, [_P, _I64, _I32, _P])})


def _points(a) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"expected [N, 3] points, got shape {a.shape}")
    return a


def voxel_subsample_host(pts: np.ndarray, cell: float) -> np.ndarray:
    """Barycenter voxel downsampling (reference grid_subsampling.cpp
    semantics; voxels in first-seen order)."""
    pts = np.ascontiguousarray(pts, np.float32)
    if len(pts) == 0:
        return pts
    out = np.empty_like(pts)
    n = _HOST.load().buffer_grid_subsample(
        pts.ctypes.data, len(pts), ctypes.c_float(cell), out.ctypes.data,
        len(pts))
    return out[:n].copy()


def radius_neighbors_host(queries: np.ndarray, support: np.ndarray,
                          radius: float, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The first ``k`` support points within ``radius`` of each query by
    ascending distance.  Returns (idx [Q, k] int32, padded with the shadow
    index len(support); counts [Q] int32, at most k)."""
    queries, support = _points(queries), _points(support)
    idx = np.empty((len(queries), k), np.int32)
    counts = np.empty((len(queries),), np.int32)
    _HOST.load().buffer_radius_neighbors(
        queries.ctypes.data, len(queries), support.ctypes.data, len(support),
        radius, k, idx.ctypes.data, counts.ctypes.data)
    return idx, counts


def knn_host(queries: np.ndarray, support: np.ndarray, k: int,
             cell: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
    """The exact ``k`` nearest support points of each query by ascending
    distance.  Returns (idx [Q, k] int32, padded with the shadow index
    len(support); counts [Q] int32).

    ``cell`` sizes the hash grid; by default 1.3 times the median k-th
    neighbour distance of 64 queries estimated on a subsample of the
    support (surfaces defeat a volumetric density estimate)."""
    queries, support = _points(queries), _points(support)
    ns = len(support)
    if cell is None:
        m = min(64, len(queries))
        s = min(ns, 8192)
        qi = np.linspace(0, len(queries) - 1, m).astype(np.int64)
        si = (np.random.RandomState(0).choice(ns, s, replace=False)
              if ns > s else np.arange(ns))
        d = np.linalg.norm(queries[qi][:, None] - support[si][None], axis=-1)
        # the k-th neighbour in full ~ the (k s / ns)-th in the subsample
        kk = max(1, min(int(round(k * s / ns)), s - 1))
        cell = 1.3 * float(np.median(np.partition(d, kk, axis=1)[:, kk]))
        cell = max(cell, 1e-4)
    idx = np.empty((len(queries), k), np.int32)
    counts = np.empty((len(queries),), np.int32)
    _HOST.load().buffer_knn(queries.ctypes.data, len(queries),
                            support.ctypes.data, ns, cell, k, idx.ctypes.data,
                            counts.ctypes.data)
    return idx, counts


def normals_host(pts: np.ndarray, knn: int = 30) -> np.ndarray:
    """kNN-PCA normals oriented toward the origin (Open3D's
    ``estimate_normals`` + ``orient_normals_towards_camera_location()``):
    [N, 3] -> [N, 3]."""
    pts = _points(pts)
    idx, counts = knn_host(pts, pts, knn)
    out = np.empty_like(pts)
    _HOST.load().buffer_normals(pts.ctypes.data, len(pts), idx.ctypes.data,
                                counts.ctypes.data, idx.shape[1],
                                out.ctypes.data)
    return out


def fps_host(pts: np.ndarray, num_samples: int) -> np.ndarray:
    """Farthest point sampling from point 0: ``num_samples`` int32
    indices."""
    pts = _points(pts)
    if len(pts) == 0:
        raise ValueError("fps_host: no points")
    out = np.empty((num_samples,), np.int32)
    _HOST.load().buffer_fps(pts.ctypes.data, len(pts), num_samples,
                            out.ctypes.data)
    return out
