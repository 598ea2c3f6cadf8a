"""Neighbour search (counterpart of ``buffer_tpu/ops/neighbors.py``).

* :func:`radius_knn` -- exact radius-limited kNN: chunked
  ``|q|^2 - 2 q.s + |s|^2`` distances and ``torch.topk`` (the reference's
  unbanded search, which runs outside any Pallas kernel);
* :func:`nearest` -- exact 1-NN through the CUDA kernel
  ``kernels/geom_cuda.nearest_cuda``;
* :func:`ball_sample_planes` -- random-priority ball sampling through
  ``kernels/geom_cuda.ball_sample_planes_cuda``.

All take a batch of clouds [B, ...] and validity masks.  The rank-banded
search of the reference (``knn_band`` > 0 with ``2*band < S``) is not
ported yet and raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from buffer_tpu_torch.kernels.geom_cuda import (ball_sample_planes_cuda,
                                                nearest_cuda)

BIG = 1e9


def _check_band(band: Optional[int], support_size: int) -> None:
    if band and 2 * band < support_size:
        raise NotImplementedError(
            "banded kernels not yet ported: run with static.knn_band = 0 "
            f"(band={band}, support={support_size})")


def radius_knn(query: torch.Tensor, support: torch.Tensor,
               support_valid: torch.Tensor, k: int,
               radius: Optional[float] = None, query_chunk: int = 4096,
               band: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k nearest valid support points of each query, optionally within
    ``radius``.

    query [B, Q, 3], support [B, S, 3], support_valid [B, S] -> (d2 [B, Q, k]
    ascending, idx [B, Q, k] int32, valid [B, Q, k]).  Slots past the
    in-radius count are invalid with d2 = 1e9 and idx 0 (the shadow
    neighbours of the reference)."""
    B, Q, _ = query.shape
    S = support.shape[1]
    _check_band(band, S)
    r2 = None if radius is None else float(radius) ** 2
    s2 = torch.sum(support * support, dim=-1)                     # [B, S]
    d_out = torch.empty((B, Q, k), dtype=query.dtype, device=query.device)
    i_out = torch.empty((B, Q, k), dtype=torch.int32, device=query.device)
    for q0 in range(0, Q, query_chunk):
        q = query[:, q0:q0 + query_chunk]
        q2 = torch.sum(q * q, dim=-1, keepdim=True)
        d2 = torch.clamp(q2 - 2.0 * (q @ support.transpose(1, 2))
                         + s2[:, None, :], min=0.0)
        bad = ~support_valid[:, None, :]
        if r2 is not None:
            bad = bad | (d2 > r2)
        d2 = torch.where(bad, torch.full_like(d2, BIG), d2)
        if S < k:
            d2 = torch.cat([d2, torch.full(d2.shape[:2] + (k - S,), BIG,
                                           dtype=d2.dtype, device=d2.device)], -1)
        d, i = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
        d_out[:, q0:q0 + query_chunk] = d
        i_out[:, q0:q0 + query_chunk] = torch.where(
            d < BIG, i, torch.zeros_like(i)).to(torch.int32)
    return d_out, i_out, d_out < BIG


def nearest(query: torch.Tensor, support: torch.Tensor,
            support_valid: torch.Tensor, band: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN: query [B, Q, 3] over support [B, S, 3] -> (d2 [B, Q],
    idx [B, Q] int32).  Replaces KNN_CUDA(k=1) (models/BUFFER.py:335-359)."""
    _check_band(band, support.shape[1])
    return nearest_cuda(query, support, support_valid)


def ball_sample_planes(query: torch.Tensor, support: torch.Tensor,
                       support_valid: torch.Tensor, prio: torch.Tensor,
                       radius: float, k: int):
    """Random k-subset of each query's radius ball as coordinate planes:
    the top-2 priorities of each of k/2 contiguous segments of the
    (shuffled) support.  Returns (x, y, z, valid) [B, Q, k]; reference
    pointnet2 ball_query over a shuffled cloud (models/patch_embedder.py:97)."""
    return ball_sample_planes_cuda(query, support, support_valid, prio,
                                   radius, k)


def gather_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: arr [B, N, D], idx [B, ...] -> [B, ..., D]."""
    B = arr.shape[0]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(arr, 1, flat[..., None].expand(-1, -1, arr.shape[-1]))
    return out.reshape(idx.shape + (arr.shape[-1],))
