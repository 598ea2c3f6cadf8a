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
  :func:`nearest`;
* :func:`radius_knn_banded` and :func:`nearest_banded` -- the banded
  search where the kernels cannot take the support (past their 16-bit
  rank, or under 16 grid rows): each query block searches a contiguous
  window of support ranks, gathered from device-side starts, with exact
  fp32 distances and an exact ``torch.topk`` / ``torch.min``.

All take a batch of clouds [B, ...] and validity masks.  The dispatch is
the TPU path's own (``buffer_tpu/ops/neighbors.py:98-126, 402-411``):
:func:`knn_route` and :func:`nearest_route` name the branch a shape takes;
a search without ``query_valid`` takes no banded kernel, as on the TPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from buffer_tpu_torch.core.numerics import full_fp32
from buffer_tpu_torch.kernels.geom_cuda import (ball_sample_planes_cuda,
                                                ball_sample_points_cuda,
                                                nearest_cuda)
from buffer_tpu_torch.kernels.knn_cuda import (banded_knn_cuda, banded_nn1_cuda,
                                               banded_supported,
                                               banded_win_rows)

BIG = 1e9
# elements of one [B, blocks, queries, window] distance field of the
# banded fallbacks (128 MB of fp32): a search stays within ~0.5 GB
FIELD_ELEMS = 1 << 25


def knn_route(support_size: int, band: Optional[int],
              masked: bool = True) -> str:
    """"banded" (the banded kernel; the band restricts the search, or its
    window covers the whole grid), "fallback" (:func:`radius_knn_banded`: a
    restricting band on a support the kernel cannot take, or a search
    without query masks) or "dense" (the exact search).  ``masked``: the
    caller passes ``query_valid``; the kernel's window follows the ratio of
    the valid counts, so without the masks the TPU path never takes it
    (``buffer_tpu/ops/neighbors.py:98``)."""
    S = support_size
    if masked and band and banded_supported(S):
        _, covers = banded_win_rows(S, band)
        if 2 * band < S or covers:
            return "banded"
    if band and 2 * band < S:
        return "fallback"
    return "dense"


def nearest_route(support_size: int, band: Optional[int],
                  masked: bool = True) -> str:
    """"banded" (the banded 1-NN kernel) when the band restricts the search,
    the kernel takes the support and the caller passes ``query_valid``
    (``masked``), "fallback" (:func:`nearest_banded`) when it restricts
    otherwise, else "exact"."""
    S = support_size
    if band and 2 * band < S:
        return "banded" if masked and banded_supported(S) else "fallback"
    return "exact"


def radius_knn(query: torch.Tensor, support: torch.Tensor,
               support_valid: torch.Tensor, k: int,
               radius: Optional[float] = None, query_chunk: int = 4096,
               band: Optional[int] = None,
               query_valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k nearest valid support points of each query, optionally within
    ``radius``.

    query [B, Q, 3], support [B, S, 3], support_valid [B, S], query_valid
    [B, Q] (the banded kernel's window follows it; without it a
    restricting band takes the fallback) -> (d2 [B, Q, k] ascending,
    idx [B, Q, k] int32, valid [B, Q, k]).  The banded branch returns the
    truncated distances of its packed keys (low 16 mantissa bits clear) and
    may hold any index in slots that are not valid; the dense and fallback
    branches put d2 = 1e9 and idx 0 there (the shadow neighbours of the
    reference)."""
    B, Q, _ = query.shape
    S = support.shape[1]
    route = knn_route(S, band, query_valid is not None)
    if route == "banded":
        wr, _ = banded_win_rows(S, band)
        return banded_knn_cuda(query, support, support_valid, query_valid, k,
                               radius, wr)
    if route == "fallback":
        return radius_knn_banded(query, support, support_valid, k, radius,
                                 band, query_valid=query_valid)
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
    The banded branch (with ``query_valid``) searches +-1024 ranks and
    returns truncated d2; the fallback searches the window of
    :func:`nearest_banded`."""
    route = nearest_route(support.shape[1], band, query_valid is not None)
    if route == "banded":
        return banded_nn1_cuda(query, support, support_valid, query_valid)
    if route == "fallback":
        return nearest_banded(query, support, support_valid, band,
                              query_valid=query_valid)
    return nearest_cuda(query, support, support_valid)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _band_starts(Q: int, S: int, qb: int, win: int,
                 q_valid: Optional[torch.Tensor] = None,
                 s_valid: Optional[torch.Tensor] = None,
                 device=None) -> torch.Tensor:
    """First support rank of the window of each block of ``qb`` queries,
    ``buffer_tpu/ops/neighbors.py:203-222`` in its fp32 arithmetic: the
    block centre scaled by the ratio of the valid counts (q_valid [B, .],
    s_valid [B, S]; S / Q without masks), less half the window, rounded,
    clipped to [0, S - win], aligned down to 256.  Returns [B, Q // qb]
    int32 ([Q // qb] without masks), on the device."""
    dev = s_valid.device if s_valid is not None else device
    centers = torch.arange(0, Q, qb, dtype=torch.float32, device=dev) + qb / 2
    if q_valid is not None and s_valid is not None:
        qn = torch.clamp(torch.sum(q_valid.to(torch.float32), dim=-1), min=1.0)
        sn = torch.clamp(torch.sum(s_valid.to(torch.float32), dim=-1), min=1.0)
        scaled = centers * (sn / qn)[..., None]
    else:
        scaled = centers * (S / Q)
    starts = torch.clamp(torch.round(scaled - win / 2), 0, max(S - win, 0))
    return (starts / 256.0).to(torch.int32) * 256


def _windows(query, support, support_valid, starts, qb, win):
    """Query blocks and the support windows they search, a group of blocks
    at a time (each group's distance field within FIELD_ELEMS): yields
    (first block, [B, G, qb, win] fp32 distances with the invalid support
    at 1e9, [B, G, win] support ranks).  The ranks come from the
    device-side starts, so the search reads nothing back to the host."""
    B, Qp = query.shape[:2]
    nblk = Qp // qb
    cols = torch.arange(win, device=query.device)
    s2 = torch.sum(support * support, dim=-1)
    G = max(1, FIELD_ELEMS // (B * qb * win))
    for g0 in range(0, nblk, G):
        g = min(G, nblk - g0)
        rows = starts[:, g0:g0 + g, None].long() + cols         # [B, g, win]
        flat = rows.reshape(B, -1)
        sw = gather_rows(support, flat).reshape(B, g, win, 3)
        vw = torch.gather(support_valid, 1, flat).reshape(B, g, 1, win)
        s2w = torch.gather(s2, 1, flat).reshape(B, g, 1, win)
        qc = query[:, g0 * qb:(g0 + g) * qb].reshape(B, g, qb, 3)
        q2 = torch.sum(qc * qc, dim=-1, keepdim=True)
        # (|q|^2 - 2 q.s) + |s|^2, the reference's order, in place
        d2 = (qc @ sw.transpose(-1, -2)).mul_(-2.0).add_(q2).add_(s2w)
        yield g0, d2.masked_fill_(~vw, BIG), rows


def _padded(query: torch.Tensor, qb: int) -> torch.Tensor:
    Q = query.shape[1]
    pad = _round_up(Q, qb) - Q
    return torch.nn.functional.pad(query, (0, 0, 0, pad)) if pad else query


def radius_knn_banded(query: torch.Tensor, support: torch.Tensor,
                      support_valid: torch.Tensor, k: int,
                      radius: Optional[float], band: int,
                      query_block: int = 1024,
                      query_valid: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-banded radius-kNN for Morton-ordered clouds
    (``buffer_tpu/ops/neighbors.py:225-279``): each block of
    ``query_block`` queries searches the ``2 * band`` support ranks from
    its :func:`_band_starts` start.  The distances are exact fp32 (TF32
    off), the radius and validity are judged on them, and the k nearest
    come from an exact sorted ``torch.topk`` (the reference's bf16 scores
    and ``approx_max_k`` are TPU workarounds).  Returns :func:`radius_knn`'s
    contract: (d2 [B, Q, k] ascending, idx [B, Q, k] int32, valid), d2 =
    1e9 and idx 0 where not valid."""
    B, Q, _ = query.shape
    S = support.shape[1]
    win, qb = 2 * band, query_block
    qpad = _padded(query, qb)
    starts = _band_starts(qpad.shape[1], S, qb, win, query_valid,
                          support_valid, device=query.device)
    starts = starts.expand(B, -1)
    r2 = None if radius is None else float(radius) ** 2
    d_out = torch.empty((B, qpad.shape[1], k), dtype=query.dtype,
                        device=query.device)
    i_out = torch.empty((B, qpad.shape[1], k), dtype=torch.int32,
                        device=query.device)
    with full_fp32():
        for g0, d2, rows in _windows(qpad, support, support_valid, starts, qb,
                                     win):
            if r2 is not None:
                d2 = d2.masked_fill_(d2 > r2, BIG)
            d, loc = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
            ok = d < BIG
            idx = torch.gather(rows[:, :, None, :].expand(-1, -1, qb, -1), 3,
                               loc)
            sl = slice(g0 * qb, g0 * qb + d.shape[1] * qb)
            d_out[:, sl] = torch.clamp(d, min=0.0).reshape(B, -1, k)
            i_out[:, sl] = torch.where(ok, idx, torch.zeros_like(idx)).reshape(
                B, -1, k).to(torch.int32)
    d_out, i_out = d_out[:, :Q], i_out[:, :Q]
    return d_out, i_out, d_out < BIG


def nearest_banded(query: torch.Tensor, support: torch.Tensor,
                   support_valid: torch.Tensor, band: int,
                   query_block: int = 512,
                   query_valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-banded 1-NN for Morton-ordered clouds, exact within its window
    (``buffer_tpu/ops/neighbors.py:339-382``): each block of
    ``query_block`` queries searches ``min(round_up(2 * band + span, 256),
    S)`` support ranks, ``span`` the ranks one block spans, from its
    :func:`_band_starts` start; exact fp32 distances (TF32 off), the first
    minimum.  Returns (d2 [B, Q] clamped at 0, idx [B, Q] int32)."""
    B, Q, _ = query.shape
    S = support.shape[1]
    qb = query_block
    span = -(-qb * S // Q)
    win = min(_round_up(2 * band + span, 256), S)
    qpad = _padded(query, qb)
    starts = _band_starts(qpad.shape[1], S, qb, win, query_valid,
                          support_valid, device=query.device).expand(B, -1)
    d_out = torch.empty((B, qpad.shape[1]), dtype=query.dtype,
                        device=query.device)
    i_out = torch.empty((B, qpad.shape[1]), dtype=torch.int32,
                        device=query.device)
    with full_fp32():
        for g0, d2, rows in _windows(qpad, support, support_valid, starts, qb,
                                     win):
            d, loc = torch.min(d2, dim=-1)                         # [B, g, qb]
            sl = slice(g0 * qb, g0 * qb + d.shape[1] * qb)
            d_out[:, sl] = torch.clamp(d, min=0.0).reshape(B, -1)
            i_out[:, sl] = torch.gather(rows, 2, loc).reshape(B, -1).to(
                torch.int32)
    return d_out[:, :Q], i_out[:, :Q]


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
