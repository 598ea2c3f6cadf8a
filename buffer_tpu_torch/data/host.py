"""ctypes binding of the native host grid subsampler.

Counterpart of ``buffer_tpu/kernels/host.py``.  The library is built from
the repository's ``cpp/host_ops.cpp`` (the C ABI ``buffer_grid_subsample``)
into ``build/host/`` at first use, with portable flags: ``cpp/Makefile``
builds for the building machine's own CPU (``-march=native``), so a
library built elsewhere is never loaded.
"""

from __future__ import annotations

import ctypes

import numpy as np

from buffer_tpu_torch.kernels.cuda import REPO_ROOT, NativeLib

_HOST = NativeLib(
    "bufferhost", [REPO_ROOT / "cpp" / "host_ops.cpp"], "g++",
    ["-O3", "-std=c++17", "-fPIC", "-shared"], "host",
    {"buffer_grid_subsample": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_int64])})


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
