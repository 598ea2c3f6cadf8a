"""Host-side preprocessing: raw clouds -> static padded PairInputs.

Counterpart of ``buffer_tpu/data/preprocess.py``: double voxel
downsampling, shuffles, caps, Morton ordering of the point-learner clouds,
host-built pyramid levels and zero-padding to the static plan.  Draws come
from a ``numpy.random.RandomState`` in the same order as the reference, so
the same seed gives the same arrays in both packages.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from buffer_tpu_torch import resolve_device
from buffer_tpu_torch.config import Config
from buffer_tpu_torch.data.host import voxel_subsample_host
from buffer_tpu_torch.utils import profiling


def morton_sort(pts: np.ndarray, bits: int = 10) -> np.ndarray:
    """Order points along a Z-order (Morton) curve (stable)."""
    if len(pts) == 0:
        return pts
    lo = pts.min(axis=0)
    span = pts.max(axis=0) - lo + 1e-9
    q = ((pts - lo) / span * (2 ** bits - 1)).astype(np.uint32)
    code = np.zeros(len(pts), np.uint64)
    for b in range(bits):
        for d in range(3):
            code |= ((q[:, d] >> b) & 1).astype(np.uint64) << np.uint64(3 * b + d)
    return pts[np.argsort(code, kind="stable")]


def pad_cloud(pts: np.ndarray, n: int, rs: Optional[np.random.RandomState] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Cap to n points (a sorted random subset, so order is kept) and
    zero-pad to n with a mask."""
    if len(pts) > n:
        rs = rs or np.random
        idx = np.sort(rs.choice(len(pts), n, replace=False))
        pts = pts[idx]
    out = np.zeros((n, 3), np.float32)
    out[: len(pts)] = pts
    mask = np.zeros((n,), bool)
    mask[: len(pts)] = True
    return out, mask


def prepare_pair(cfg: Config, src_raw: np.ndarray, tgt_raw: np.ndarray,
                 rs: Optional[np.random.RandomState] = None,
                 already_downsampled: bool = False, device=None):
    """Build :class:`~buffer_tpu_torch.pipeline.registration.PairInputs`
    (with host-built ``lvl1``/``lvl2``) from two raw clouds, on ``device``
    (default: the CUDA card).  Its host seconds add to the ``prep.s``
    counter (:func:`~buffer_tpu_torch.utils.profiling.counters`)."""
    t0 = time.perf_counter()
    out = _prepare_pair(cfg, src_raw, tgt_raw, rs, already_downsampled, device)
    profiling.count("prep.s", time.perf_counter() - t0)
    return out


def _prepare_pair(cfg, src_raw, tgt_raw, rs, already_downsampled, device):
    from buffer_tpu_torch.pipeline.registration import PairInputs

    dev = resolve_device(device)
    rs = rs or np.random.RandomState(0)
    st = cfg.static

    def stage(pts):
        fds = pts if already_downsampled else voxel_subsample_host(
            pts, cfg.data.downsample)
        rs.shuffle(fds)
        sds = voxel_subsample_host(fds, cfg.data.voxel_size_0)
        rs.shuffle(sds)
        if len(sds) > cfg.data.max_numPts:
            sds = sds[rs.choice(len(sds), cfg.data.max_numPts, replace=False)]
        return fds.astype(np.float32), sds.astype(np.float32)

    s_fds, s_sds = stage(src_raw)
    t_fds, t_sds = stage(tgt_raw)

    def check_cap(name, arr, cap):
        if len(arr) > cap:
            warnings.warn(
                f"cloud with {len(arr)} points exceeds static plan "
                f"{name}={cap}; randomly subsampling", RuntimeWarning)

    for name, arr, cap in (("raw_points", s_fds, st.raw_points),
                           ("raw_points", t_fds, st.raw_points),
                           ("points_l0", s_sds, st.points_l0),
                           ("points_l0", t_sds, st.points_l0)):
        check_cap(name, arr, cap)
    s_sds = morton_sort(s_sds)
    t_sds = morton_sort(t_sds)
    r0, m0 = pad_cloud(s_fds, st.raw_points, rs)
    r1, m1 = pad_cloud(t_fds, st.raw_points, rs)
    s0, n0 = pad_cloud(s_sds, st.points_l0, rs)
    s1, n1 = pad_cloud(t_sds, st.points_l0, rs)

    def levels(sds):
        l1 = morton_sort(voxel_subsample_host(sds, 2 * cfg.data.voxel_size_0))
        l2 = morton_sort(voxel_subsample_host(l1, 4 * cfg.data.voxel_size_0))
        check_cap("points_l1", l1, st.points_l1)
        check_cap("points_l2", l2, st.points_l2)
        return l1, l2

    sl1, sl2 = levels(s_sds)
    tl1, tl2 = levels(t_sds)
    a0, am0 = pad_cloud(sl1, st.points_l1, rs)
    a1, am1 = pad_cloud(tl1, st.points_l1, rs)
    b0, bm0 = pad_cloud(sl2, st.points_l2, rs)
    b1, bm1 = pad_cloud(tl2, st.points_l2, rs)

    t = lambda *xs: torch.from_numpy(np.stack(xs)).to(dev)
    return PairInputs(raw=t(r0, r1), raw_mask=t(m0, m1),
                      sds=t(s0, s1), sds_mask=t(n0, n1),
                      lvl1=t(a0, a1), lvl1_mask=t(am0, am1),
                      lvl2=t(b0, b1), lvl2_mask=t(bm0, bm1))
