# Frozen copy of buffer_tpu_torch/kernels/knn_cuda.py at commit c88a0e7761321c01585f758b60ff2700171e6a6a: the
# plain versions of the port's kernels, which define what each kernel
# computes (launchers and plans left out).  The benchmark's reference calls
# them for the kernels' semantics only.  Do not edit.
"""Rank-banded neighbour search: the banded radius-kNN with its top-k stage,
and the banded 1-NN.

Counterparts of ``buffer_tpu/kernels/geom_pallas.py`` ``banded_knn_tpu``
(stage A) with ``topk_packed_tpu`` (stage B), and ``banded_nn1_tpu``.
Query and support of each cloud are Morton-sorted along one curve; the
support of S points is laid out as NR = ceil(S/128) rows of 128 ranks,
rank s at row s // 128 and column s % 128, ranks past S invalid.  Each
tile of 32 queries searches a window of LW consecutive rows whose start
(:func:`window_starts`) follows the tile's rank, scaled by the ratio of
the valid counts.

The ordering of the TPU kernels is the contract and carries over bit for
bit: a window point's key is ``(bits(d2) & ~0x3F) | window row``, the
per-column winner and runner-up are the smallest keys, a candidate keeps
``bits & ~0xFFFF`` of its distance (the truncated distance the pyramid
thresholds) with its rank in the low 16 bits, and stage B takes the k
smallest candidates by k rounds of min and knock-out.  Keys are int32 bit
patterns of non-negative floats, so integer order is float order.

Each wrapper takes its plain PyTorch version for CPU tensors only; a CUDA
tensor goes to ``csrc/bknn.cu`` or ``csrc/bnn1.cu``, or raises.  The
results are indices and distances of input points: no gradient flows
through them, there is no backward kernel, and a wrapper raises when an
input asks for a gradient.  The
kernels derive each tile's window start from the two valid counts on the
card, in the order of :func:`window_starts` (both sources count them while
they pack the support).  The
plain versions repeat the kernels' separately rounded arithmetic, so on
the card kernel and plain version agree bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


NSEG = 128                 # columns of the support grid (ranks per row)
Q_TILE = 32                # queries sharing one window
KNN_WIN_ROWS = 64          # 64 x 128 = 8192 ranks, +-4096
NN1_WIN_ROWS = 16          # 16 x 128 = 2048 ranks, +-1024
ROW_MASK = 0x3F
RANK_MASK = 0xFFFF
BIG = 1e9
BIG_KEY = 0x4E6E6B28       # bits of float32(1e9): the knock-out value
TINY = 1e-30               # distance floor: keeps every key a normal float
TILE_CHUNK = 4             # tiles per step of the plain versions


def banded_supported(S: int) -> bool:
    """True when the banded kernels take a support of S points: the padded
    rank fits 16 bits and the grid holds a 16-row window
    (``geom_pallas.py:744-748``)."""
    NR = -(-S // NSEG)
    return NR * NSEG <= (1 << 16) and (NR // 16) * 16 >= 16


def banded_win_rows(S: int, band: int) -> Tuple[int, bool]:
    """``(win_rows, covers_grid)`` realizing a +-``band`` rank half-width at
    support size S (``geom_pallas.py:751-765``): ``ceil(2*band/128)``
    rounded up to 16 rows, and whether the effective window
    ``min(win_rows, (NR//16)*16)`` spans every grid row (then the banded
    search is an exact full search)."""
    NR = -(-S // NSEG)
    want = -(-2 * band // NSEG)
    wr = -(-max(want, 16) // 16) * 16
    return wr, min(wr, (NR // 16) * 16) >= NR


def window_rows(S: int, win_rows: int) -> Tuple[int, int]:
    """(NR, LW): grid rows and the effective window rows; raises on a
    support the kernels do not take."""
    NR = -(-S // NSEG)
    LW = min(win_rows, (NR // 16) * 16)
    if NR * NSEG > (1 << 16) or LW < 16 or win_rows > 64:
        raise ValueError(f"banded search: support {S} with {win_rows} window "
                         "rows is outside the kernels' range")
    return NR, LW


def window_starts(support_valid: torch.Tensor, query_valid: torch.Tensor,
                  NR: int, LW: int) -> torch.Tensor:
    """First window row of every query tile, [B, n_tiles] int32.

    fp32 in the TPU kernels' order (``geom_pallas.py:554-564, 702-706``):
    ratio = max(#valid support, 1) / max(#valid query, 1);
    row = (i*32 + 16) * ratio / 128; the start is int(row/8 + 0.5)*8 - LW/2,
    clipped to [0, max(((NR - LW)//8)*8, 0)]."""
    Q = query_valid.shape[1]
    sn = torch.clamp(support_valid.to(torch.float32).sum(1), min=1.0)
    qn = torch.clamp(query_valid.to(torch.float32).sum(1), min=1.0)
    ratio = sn / qn
    i = torch.arange(-(-Q // Q_TILE), dtype=torch.float32,
                     device=query_valid.device)
    row = (i * Q_TILE + Q_TILE / 2)[None, :] * ratio[:, None] / NSEG
    r0 = (row / 8.0 + 0.5).to(torch.int32) * 8 - LW // 2
    return torch.clamp(r0, 0, max(((NR - LW) // 8) * 8, 0)).to(torch.int32)


def support_grid(support: torch.Tensor, support_valid: torch.Tensor,
                 NR: int) -> torch.Tensor:
    """[B, NR*128, 4] f32 (x, y, z, 1 if valid else 0); padded ranks are
    zeros, invalid."""
    B, S, _ = support.shape
    grid = torch.zeros((B, NR * NSEG, 4), dtype=torch.float32,
                       device=support.device)
    grid[:, :S, :3] = support
    grid[:, :S, 3] = support_valid.to(torch.float32)
    return grid


def decode(keys: torch.Tensor, S: int):
    """Packed keys -> (truncated d2, rank clipped to S-1, valid = d2 < 5e8)."""
    d = (keys & ~RANK_MASK).view(torch.float32)
    return d, torch.clamp(keys & RANK_MASK, max=S - 1), d < BIG / 2


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _window_keys(query: torch.Tensor, grid: torch.Tensor, r0: torch.Tensor,
                 t0: int, t1: int, LW: int) -> torch.Tensor:
    """Keys (bits(d2) & ~0x3F) | row of tiles t0..t1-1 of every cloud,
    [B, T, 32, LW, 128] int32."""
    B, Q, _ = query.shape
    dev = query.device
    q = torch.zeros((B, (t1 - t0) * Q_TILE, 3), dtype=torch.float32, device=dev)
    part = query[:, t0 * Q_TILE:t1 * Q_TILE]
    q[:, :part.shape[1]] = part
    q = q.reshape(B, t1 - t0, Q_TILE, 1, 1, 3)
    rows = torch.arange(LW, device=dev, dtype=torch.int32)
    cols = torch.arange(NSEG, device=dev, dtype=torch.int32)
    rank = ((r0[:, t0:t1, None, None] + rows[:, None]) * NSEG + cols).long()
    win = torch.gather(grid, 1, rank.reshape(B, -1, 1).expand(-1, -1, 4))
    win = win.reshape(B, t1 - t0, 1, LW, NSEG, 4)
    dx = q[..., 0] - win[..., 0]
    dy = q[..., 1] - win[..., 1]
    dz = q[..., 2] - win[..., 2]
    d2 = dx * dx + dy * dy
    d2 = d2 + dz * dz
    d2 = torch.where(win[..., 3] != 0, d2, d2 + BIG)
    d2 = torch.maximum(d2, torch.full((), TINY, dtype=torch.float32, device=dev))
    return (d2.view(torch.int32) & ~ROW_MASK) | rows[:, None]


def _candidate(mi: torch.Tensor, r0: torch.Tensor, r2: Optional[torch.Tensor]):
    """Stage-A winner key [B, T, 32, 128] -> packed candidate
    (bits(m) & ~0xFFFF) | rank; m = 1e9 outside the radius."""
    cols = torch.arange(NSEG, device=mi.device, dtype=torch.int32)
    rank = (r0[:, :, None, None] + (mi & ROW_MASK)) * NSEG + cols
    m = mi & ~RANK_MASK
    if r2 is not None:
        m = torch.where(m.view(torch.float32) <= r2, m,
                        torch.full_like(m, BIG_KEY & ~RANK_MASK))
    return m | rank


def topk_keys_plain(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Stage B (``topk_packed_tpu``): k rounds over keys [..., n] int32; each
    round emits the smallest key and replaces every key equal to it by
    1e9's bits.  Returns [..., k] ascending."""
    out = []
    for _ in range(k):
        m = keys.amin(-1, keepdim=True)
        out.append(m)
        keys = torch.where(keys == m, torch.full_like(keys, BIG_KEY), keys)
    return torch.cat(out, -1)


def _stage_a(query: torch.Tensor, support: torch.Tensor,
             support_valid: torch.Tensor, query_valid: torch.Tensor,
             radius: Optional[float], win_rows: int):
    """Stage A of the banded kNN a chunk of query tiles at a time: yields
    (first query of the chunk, its two candidate fields [B, n, 128] int32:
    each support column's best and second-best window row, packed)."""
    B, Q, _ = query.shape
    S = support.shape[1]
    NR, LW = window_rows(S, win_rows)
    r0 = window_starts(support_valid, query_valid, NR, LW)
    grid = support_grid(support.float(), support_valid, NR)
    r2 = (None if radius is None else
          torch.full((), float(radius) ** 2, dtype=torch.float32,
                     device=query.device))
    n_tiles = r0.shape[1]
    for t0 in range(0, n_tiles, TILE_CHUNK):
        t1 = min(t0 + TILE_CHUNK, n_tiles)
        key = _window_keys(query.float(), grid, r0, t0, t1, LW)
        m1 = key.amin(3)
        key = torch.where(key == m1[:, :, :, None], torch.full_like(key, BIG_KEY),
                          key)
        m2 = key.amin(3)
        r0c = r0[:, t0:t1]
        n = min(Q, t1 * Q_TILE) - t0 * Q_TILE
        yield t0 * Q_TILE, tuple(
            _candidate(m, r0c, r2).reshape(B, -1, NSEG)[:, :n] for m in (m1, m2))


def banded_knn_plain(query: torch.Tensor, support: torch.Tensor,
                     support_valid: torch.Tensor, query_valid: torch.Tensor,
                     k: int, radius: Optional[float],
                     win_rows: int = KNN_WIN_ROWS):
    """Banded radius-kNN over B clouds: query [B, Q, 3], support [B, S, 3],
    masks [B, S] and [B, Q] -> (d2 [B, Q, k] truncated, idx [B, Q, k]
    int32, valid [B, Q, k]) in (d2, rank) order.  Slots that are not
    valid may hold any index."""
    B, Q, _ = query.shape
    keys = torch.empty((B, Q, k), dtype=torch.int32, device=query.device)
    for q0, (c1, c2) in _stage_a(query, support, support_valid, query_valid,
                                 radius, win_rows):
        keys[:, q0:q0 + c1.shape[1]] = topk_keys_plain(torch.cat([c1, c2], -1),
                                                       k)
    d, idx, valid = decode(keys, support.shape[1])
    return d, idx.to(torch.int32), valid


def banded_nn1_plain(query: torch.Tensor, support: torch.Tensor,
                     support_valid: torch.Tensor, query_valid: torch.Tensor):
    """Banded 1-NN over B clouds (a 16-row window) -> (d2 [B, Q] truncated,
    idx [B, Q] int32): per column the smallest window key, across columns
    the smallest (bits(d2) & ~0xFFFF) | rank."""
    B, Q, _ = query.shape
    S = support.shape[1]
    NR, LW = window_rows(S, NN1_WIN_ROWS)
    r0 = window_starts(support_valid, query_valid, NR, LW)
    grid = support_grid(support.float(), support_valid, NR)
    keys = torch.empty((B, Q), dtype=torch.int32, device=query.device)
    n_tiles = r0.shape[1]
    for t0 in range(0, n_tiles, 4 * TILE_CHUNK):
        t1 = min(t0 + 4 * TILE_CHUNK, n_tiles)
        m1 = _window_keys(query.float(), grid, r0, t0, t1, LW).amin(3)
        best = _candidate(m1, r0[:, t0:t1], None).amin(-1).reshape(B, -1)
        n = min(Q, t1 * Q_TILE) - t0 * Q_TILE
        keys[:, t0 * Q_TILE:t0 * Q_TILE + n] = best[:, :n]
    d, idx, _ = decode(keys, S)
    return d, idx.to(torch.int32)
