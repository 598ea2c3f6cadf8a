"""Voxel-grid subsampling with barycentre semantics, on the device and on
the host (counterpart of ``buffer_tpu/ops/subsample.py``).

The reference's C++ hash-grid subsampler
(``cpp_wrappers/cpp_subsampling/grid_subsampling/grid_subsampling.cpp``):
voxel key from ``floor((p - floor(min / dl) * dl) / dl)``, each occupied
voxel's output the barycentre of its points.  The device version keeps a
fixed-size padded output with a validity mask: sort by voxel key, segment
mean, compaction to ``out_size``.  Its output comes in voxel-key order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def voxel_subsample(points: torch.Tensor, valid: torch.Tensor,
                    voxel_size: float, out_size: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points [N, 3], valid [N] -> (out [out_size, 3], mask [out_size]).

    Voxels past ``out_size`` in key order are dropped.  The divisions take
    a tensor divisor on the points' device (CUDA turns a division by a
    Python scalar into a product with its reciprocal), and the sums run in
    sorted order, one thread a segment on the card, so the result is bit
    for bit the same on the CPU and on the card."""
    dev, dt = points.device, points.dtype
    dl = torch.full((), voxel_size, dtype=dt, device=dev)
    masked = torch.where(valid[:, None], points, torch.full_like(points, 1e9))
    origin = torch.floor(masked.min(dim=0).values / dl) * dl
    coords = torch.floor((points - origin) / dl).to(torch.int32)
    # grid extents from the valid maximum (grid_subsampling.cpp:28-30);
    # the key wraps in int32 as the reference's does
    maxc = torch.where(valid[:, None], coords, torch.full_like(coords, -1)
                       ).max(dim=0).values
    nx, ny = maxc[0] + 1, maxc[1] + 1
    key = coords[:, 0] + nx * coords[:, 1] + nx * ny * coords[:, 2]
    key = torch.where(valid, key,
                      torch.full_like(key, torch.iinfo(torch.int32).max))

    key_s, order = torch.sort(key, stable=True)
    pts_s, valid_s = points[order], valid[order]
    starts = torch.ones_like(valid_s)
    starts[1:] = key_s[1:] != key_s[:-1]
    seg = torch.cumsum(starts.to(torch.int32), 0, dtype=torch.int32) - 1
    keep = valid_s & (seg < out_size)
    # invalid and overflowing rows go to a scratch segment; they sort last,
    # so the segment ids are non-decreasing and every segment is contiguous
    seg_c = torch.where(keep, seg, torch.full_like(seg, out_size))
    ends = torch.searchsorted(
        seg_c, torch.arange(out_size + 1, dtype=torch.int32, device=dev),
        right=True)
    lengths = torch.diff(ends, prepend=ends.new_zeros(1))
    # the lengths sum to N by construction: unsafe skips the check, which
    # reads them on the host
    sums = torch.segment_reduce(pts_s * keep[:, None].to(dt), "sum",
                                lengths=lengths, axis=0, unsafe=True)[:out_size]
    cnts = lengths[:out_size].to(dt)
    out = sums / torch.clamp(cnts, min=1.0)[:, None]
    mask = cnts > 0
    return torch.where(mask[:, None], out, torch.zeros_like(out)), mask


def voxel_subsample_np(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Host barycentre voxel downsampling (grid_subsampling.cpp semantics),
    voxels in key order, sums in float64."""
    if len(points) == 0:
        return points
    origin = np.floor(points.min(axis=0) / voxel_size) * voxel_size
    coords = np.floor((points - origin) / voxel_size).astype(np.int64)
    nx = coords[:, 0].max() + 1
    ny = coords[:, 1].max() + 1
    key = coords[:, 0] + nx * coords[:, 1] + nx * ny * coords[:, 2]
    uniq, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    sums = np.zeros((len(uniq), 3), dtype=np.float64)
    np.add.at(sums, inv, points)
    return (sums / cnt[:, None]).astype(points.dtype)
