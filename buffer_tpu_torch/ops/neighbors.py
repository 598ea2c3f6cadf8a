"""Neighbour search (counterpart of ``buffer_tpu/ops/neighbors.py``).

* :func:`radius_knn` -- radius-limited kNN: the rank-banded kernel
  (``kernels/knn_cuda.banded_knn_cuda``) where the TPU path takes
  ``banded_knn_tpu``, else the exact dense search (chunked
  ``|q|^2 - 2 q.s + |s|^2`` distances and ``torch.topk``);
* :func:`nearest` -- 1-NN: the banded kernel
  (``kernels/knn_cuda.banded_nn1_cuda``) where the TPU path takes
  ``banded_nn1_tpu``, else the exact kernel ``kernels/geom_cuda.nearest_cuda``;
* :func:`ball_sample_planes` and :func:`ball_sample_points` --
  random-priority ball sampling through
  ``kernels/geom_cuda.ball_sample_planes_cuda`` (coordinate planes, the
  inference front) and ``ball_sample_points_cuda`` (stacked points, the
  training front);
* :func:`nearest_common_morton` -- 1-NN between two clouds that are not
  sorted on one curve (the gt-warped source against the target when
  training samples its matches): a joint Morton sort on the device, then
  :func:`nearest`.

All take a batch of clouds [B, ...] and validity masks.  The dispatch is
the TPU path's own (``buffer_tpu/ops/neighbors.py:98-116, 402-411``):
:func:`knn_route` and :func:`nearest_route` name the branch a shape takes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from buffer_tpu_torch.kernels.geom_cuda import (ball_sample_planes_cuda,
                                                ball_sample_points_cuda,
                                                nearest_cuda)
from buffer_tpu_torch.kernels.knn_cuda import (banded_knn_cuda, banded_nn1_cuda,
                                               banded_supported,
                                               banded_win_rows)

BIG = 1e9


def knn_route(support_size: int, band: Optional[int]) -> str:
    """"banded" (the banded kernel; the band restricts the search, or its
    window covers the whole grid) or "dense" (the exact search).  Raises
    for a restricting band the kernel cannot take: the reference's XLA
    fallback ``radius_knn_banded`` is not ported."""
    S = support_size
    if band and banded_supported(S):
        _, covers = banded_win_rows(S, band)
        if 2 * band < S or covers:
            return "banded"
    if band and 2 * band < S:
        raise NotImplementedError(
            f"radius_knn_banded (the XLA fallback for a support of {S} "
            f"points, band {band}) is not ported")
    return "dense"


def nearest_route(support_size: int, band: Optional[int]) -> str:
    """"banded" (the banded 1-NN kernel) when the band restricts the search
    and the kernel takes the support, else "exact".  Raises for a
    restricting band the kernel cannot take: the reference's XLA fallback
    ``nearest_banded`` is not ported."""
    S = support_size
    if band and 2 * band < S:
        if banded_supported(S):
            return "banded"
        raise NotImplementedError(
            f"nearest_banded (the XLA fallback for a support of {S} points, "
            f"band {band}) is not ported")
    return "exact"


def _query_mask(query: torch.Tensor, query_valid: Optional[torch.Tensor]):
    if query_valid is None:
        raise ValueError("the banded search needs query_valid: its window "
                         "follows the ratio of the valid counts")
    return query_valid


def radius_knn(query: torch.Tensor, support: torch.Tensor,
               support_valid: torch.Tensor, k: int,
               radius: Optional[float] = None, query_chunk: int = 4096,
               band: Optional[int] = None,
               query_valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k nearest valid support points of each query, optionally within
    ``radius``.

    query [B, Q, 3], support [B, S, 3], support_valid [B, S], query_valid
    [B, Q] (needed on the banded branch) -> (d2 [B, Q, k] ascending,
    idx [B, Q, k] int32, valid [B, Q, k]).  The banded branch returns the
    truncated distances of its packed keys (low 16 mantissa bits clear) and
    may hold any index in slots that are not valid; the dense branch puts
    d2 = 1e9 and idx 0 there (the shadow neighbours of the reference)."""
    B, Q, _ = query.shape
    S = support.shape[1]
    if knn_route(S, band) == "banded":
        wr, _ = banded_win_rows(S, band)
        return banded_knn_cuda(query, support, support_valid,
                               _query_mask(query, query_valid), k, radius, wr)
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
            support_valid: torch.Tensor, band: Optional[int] = None,
            query_valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN: query [B, Q, 3] over support [B, S, 3] -> (d2 [B, Q],
    idx [B, Q] int32).  Replaces KNN_CUDA(k=1) (models/BUFFER.py:335-359).
    The banded branch searches +-1024 ranks and returns truncated d2."""
    if nearest_route(support.shape[1], band) == "banded":
        return banded_nn1_cuda(query, support, support_valid,
                               _query_mask(query, query_valid))
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


def ball_sample_points(query: torch.Tensor, support: torch.Tensor,
                       support_valid: torch.Tensor, prio: torch.Tensor,
                       radius: float, k: int):
    """:func:`ball_sample_planes` with the coordinates stacked: (points
    [B, Q, k, 3], valid [B, Q, k]); the JAX package's
    ``ball_sample_points_tpu`` (kernels/geom_pallas.py:115)."""
    return ball_sample_points_cuda(query, support, support_valid, prio,
                                   radius, k)


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x (int64) to bit positions 0, 3, ..., 27."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(pts: torch.Tensor, valid: torch.Tensor, lo: torch.Tensor,
                 span: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Z-order codes [..] int64 of pts [.., 3] over the box (lo, lo + span),
    code bit 3b+d from bit b of dimension d (``buffer_tpu/ops/
    neighbors.py:296-307``, whose uint32 codes these equal); invalid rows
    get 0xFFFFFFFF and sort last."""
    top = float(2 ** bits - 1)
    q = torch.clamp((pts - lo) / span * top, 0.0, top).to(torch.int64)
    code = (_spread3(q[..., 0]) | (_spread3(q[..., 1]) << 1)
            | (_spread3(q[..., 2]) << 2))
    return torch.where(valid, code, torch.full_like(code, 0xFFFFFFFF))


def nearest_common_morton(query: torch.Tensor, q_valid: torch.Tensor,
                          support: torch.Tensor, s_valid: torch.Tensor,
                          band: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN of query [Q, 3] over support [S, 3], two clouds not sorted on
    one curve (``buffer_tpu/ops/neighbors.py:310-336``): both are sorted on
    the Morton curve of their joint bounding box (stable sorts: codes of
    10 bits a dimension tie often), :func:`nearest` runs on the sorted
    arrays with ``band``, and the results return to the original order.
    Returns (d2 [Q], idx [Q] int32 into the original support order)."""
    big = lambda p, v, fill: torch.where(v[:, None], p, torch.full_like(p, fill))
    lo = torch.minimum(big(query, q_valid, BIG).amin(0),
                       big(support, s_valid, BIG).amin(0))
    hi = torch.maximum(big(query, q_valid, -BIG).amax(0),
                       big(support, s_valid, -BIG).amax(0))
    span = torch.clamp(hi - lo, min=1e-9)
    pq = torch.argsort(morton_codes(query, q_valid, lo, span), stable=True)
    ps = torch.argsort(morton_codes(support, s_valid, lo, span), stable=True)
    d2s, nns = nearest(query[pq][None], support[ps][None], s_valid[ps][None],
                       band=band, query_valid=q_valid[pq][None])
    inv = torch.empty_like(pq)
    inv[pq] = torch.arange(pq.shape[0], device=pq.device)
    return d2s[0][inv], ps[nns[0].long()][inv].to(torch.int32)


def gather_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: arr [B, N, D], idx [B, ...] -> [B, ..., D]."""
    B = arr.shape[0]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(arr, 1, flat[..., None].expand(-1, -1, arr.shape[-1]))
    return out.reshape(idx.shape + (arr.shape[-1],))
