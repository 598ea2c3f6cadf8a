"""Plain NumPy reference of the port's host prep: two raw clouds to the
padded static inputs of a pair.

The semantics of ``buffer_tpu_torch/data/preprocess.py`` (``prepare_pair``,
``morton_sort``, ``pad_cloud``) and of ``cpp/host_ops.cpp``'s
``buffer_grid_subsample`` at commit c88a0e7761321c01585f758b60ff2700171e6a6a,
written again in NumPy: barycentre voxel downsampling with voxels in the
order their first point comes, float32 grid arithmetic and float64 sums in
point order; the ``RandomState`` draws (shuffles, caps, subsets) in the
same order.  It shares no code with the program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def voxel_subsample(pts: np.ndarray, cell: float) -> np.ndarray:
    """Barycentre of each voxel of edge ``cell``, voxels in first-seen
    order."""
    pts = np.ascontiguousarray(pts, np.float32)
    if len(pts) == 0:
        return pts
    c = np.float32(cell)
    origin = np.floor(pts.min(axis=0) / c) * c
    ijk = np.floor((pts - origin) / c).astype(np.int64)
    nx = int(np.floor((pts[:, 0].max() - origin[0]) / c)) + 1
    ny = int(np.floor((pts[:, 1].max() - origin[1]) / c)) + 1
    key = ijk[:, 0] + nx * ijk[:, 1] + nx * ny * ijk[:, 2]
    _, first, inv = np.unique(key, return_index=True, return_inverse=True)
    slot = np.empty(len(first), np.int64)
    slot[np.argsort(first, kind="stable")] = np.arange(len(first))
    s = slot[inv.reshape(-1)]
    sums = np.zeros((len(first), 3), np.float64)
    np.add.at(sums, s, pts.astype(np.float64))
    cnt = np.bincount(s, minlength=len(first)).astype(np.float64)
    return (sums / cnt[:, None]).astype(np.float32)


def morton_sort(pts: np.ndarray, bits: int = 10) -> np.ndarray:
    """Points ordered along a 10-bit Z-order curve (stable)."""
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


def pad_cloud(pts: np.ndarray, n: int, rs: np.random.RandomState):
    """A sorted random subset of n points when there are more, then zeros
    to n, with the mask."""
    if len(pts) > n:
        pts = pts[np.sort(rs.choice(len(pts), n, replace=False))]
    out = np.zeros((n, 3), np.float32)
    out[:len(pts)] = pts
    mask = np.zeros((n,), bool)
    mask[:len(pts)] = True
    return out, mask


def prepare_pair(cfg, src_raw: np.ndarray, tgt_raw: np.ndarray,
                 rs: np.random.RandomState,
                 already_downsampled: bool) -> Dict[str, np.ndarray]:
    """{raw, raw_mask, sds, sds_mask, lvl1, lvl1_mask, lvl2, lvl2_mask},
    each stacked over (source, target).  Shuffles its inputs in place, as
    the program does."""
    st, data = cfg.static, cfg.data

    def stage(pts):
        fds = pts if already_downsampled else voxel_subsample(
            pts, data.downsample)
        rs.shuffle(fds)
        sds = voxel_subsample(fds, data.voxel_size_0)
        rs.shuffle(sds)
        if len(sds) > data.max_numPts:
            sds = sds[rs.choice(len(sds), data.max_numPts, replace=False)]
        return fds.astype(np.float32), sds.astype(np.float32)

    s_fds, s_sds = stage(src_raw)
    t_fds, t_sds = stage(tgt_raw)
    s_sds, t_sds = morton_sort(s_sds), morton_sort(t_sds)
    out = {}
    r0, m0 = pad_cloud(s_fds, st.raw_points, rs)
    r1, m1 = pad_cloud(t_fds, st.raw_points, rs)
    s0, n0 = pad_cloud(s_sds, st.points_l0, rs)
    s1, n1 = pad_cloud(t_sds, st.points_l0, rs)

    def levels(sds):
        l1 = morton_sort(voxel_subsample(sds, 2 * data.voxel_size_0))
        l2 = morton_sort(voxel_subsample(l1, 4 * data.voxel_size_0))
        return l1, l2

    sl1, sl2 = levels(s_sds)
    tl1, tl2 = levels(t_sds)
    a0, am0 = pad_cloud(sl1, st.points_l1, rs)
    a1, am1 = pad_cloud(tl1, st.points_l1, rs)
    b0, bm0 = pad_cloud(sl2, st.points_l2, rs)
    b1, bm1 = pad_cloud(tl2, st.points_l2, rs)
    for k, (x, y) in {"raw": (r0, r1), "raw_mask": (m0, m1),
                      "sds": (s0, s1), "sds_mask": (n0, n1),
                      "lvl1": (a0, a1), "lvl1_mask": (am0, am1),
                      "lvl2": (b0, b1), "lvl2_mask": (bm0, bm1)}.items():
        out[k] = np.stack([x, y])
    return out
