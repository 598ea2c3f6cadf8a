"""PyTorch models of the Hopper designs of the banded kNN (``csrc/bknn.cu``),
ball sampling (``csrc/ball.cu``), the banded 1-NN (``csrc/bnn1.cu``) and
the exact 1-NN (``csrc/nearest.cu``), held bit for bit to the plain
versions, and their launch plans at the presets' call shapes.

A CUDA kernel cannot run here; each model repeats its kernel's algorithm
(packing, staging order, comparisons and updates) in PyTorch so that the
reordering is shown to keep the plain version's bits on the CPU.  The plain
versions are held to the Pallas kernels by ``tests/test_torch_banded.py``
and ``tests/test_torch_kernels.py``; the kernels to the plain versions on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from buffer_tpu_torch.config import kitti_cfg, threedmatch_cfg, tiny_cfg
from buffer_tpu_torch.data.preprocess import morton_sort
from buffer_tpu_torch.kernels import cuda, geom_cuda, knn_cuda
from buffer_tpu_torch.ops import neighbors
from buffer_tpu_torch.utils.plan_sweep import (BNN1_ALTERNATIVES,
                                                NEAREST_ALTERNATIVES,
                                                ball_variant)

torch.set_num_threads(1)

INF = float("inf")


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _i32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32)


# ---------------------------------------------------------------------------
# banded kNN
# ---------------------------------------------------------------------------


def _window_start(tile: int, ns: int, nq: int, NR: int, LW: int) -> int:
    """csrc/bknn.cu window_start, operation for operation in fp32."""
    ratio = _f32(max(ns, 1)) / _f32(max(nq, 1))
    center = (_f32(tile) * 32 + 16) * ratio
    row = center / 128
    r0 = int((row / 8 + 0.5).to(torch.int32)) * 8 - LW // 2
    return min(max(r0, 0), max(((NR - LW) // 8) * 8, 0))


def _bknn_kernel_model(query, support, sv, qv, k, radius, win_rows):
    """csrc/bknn.cu in PyTorch: the support packed as (x, y, z, pen), each
    tile's window streamed in 8-row chunks; keys compared as floats with a
    +inf sentinel; candidates; stage B's k rounds of min and knock-out."""
    B, Q, _ = query.shape
    S = support.shape[1]
    NR, LW = knn_cuda.window_rows(S, win_rows)
    packed = torch.zeros((B, NR * 128, 4))
    packed[..., 3] = 1e9
    packed[:, :S, :3] = support
    packed[:, :S, 3] = torch.where(sv, _f32(0.0), _f32(1e9))
    r2 = None if radius is None else _f32(float(radius) ** 2)
    keys_out = torch.empty((B, Q, k), dtype=torch.int32)
    cols = torch.arange(128, dtype=torch.int32)
    big = _i32(knn_cuda.BIG_KEY)
    for b in range(B):
        ns, nq = int(sv[b].sum()), int(qv[b].sum())
        for t in range(-(-Q // 32)):                        # one block a tile
            r0 = _window_start(t, ns, nq, NR, LW)
            assert r0 % 8 == 0 and 0 <= r0 and r0 + LW <= NR
            q = torch.zeros((32, 1, 3))
            part = query[b, t * 32:(t + 1) * 32]
            q[:part.shape[0], 0] = part
            b1 = torch.full((32, 128), INF)
            b2 = torch.full((32, 128), INF)
            for c in range(0, LW, 8):                       # one ring chunk
                chunk = packed[b, (r0 + c) * 128:(r0 + c + 8) * 128]
                for rr, p in enumerate(chunk.reshape(8, 128, 4)):
                    dx = q[..., 0] - p[:, 0]
                    dy = q[..., 1] - p[:, 1]
                    dz = q[..., 2] - p[:, 2]
                    d = (dx * dx + dy * dy) + dz * dz
                    d = torch.maximum(d + p[:, 3], _f32(1e-30))
                    key = ((d.view(torch.int32) & ~0x3F)
                           | (c + rr)).view(torch.float32)
                    b2 = torch.minimum(b2, torch.maximum(b1, key))
                    b1 = torch.minimum(b1, key)
            cand = []
            for kb in (b1.view(torch.int32),
                       torch.minimum(b2.view(torch.int32), big)):
                rank = (r0 + (kb & 0x3F)) * 128 + cols
                m = kb & ~0xFFFF
                if r2 is not None:
                    m = torch.where(m.view(torch.float32) <= r2, m,
                                    _i32(knn_cuda.BIG_KEY & ~0xFFFF))
                cand.append(m | rank)
            n = part.shape[0]
            keys_out[b, t * 32:t * 32 + n] = knn_cuda.topk_keys_plain(
                torch.cat(cand, -1)[:n], k)
    d, idx, valid = knn_cuda.decode(keys_out, S)
    return d, idx.to(torch.int32), valid


def _sorted_cloud(rs, n, extent=1.0):
    c = rs.uniform(-extent, extent, (n, 3)).astype(np.float32)
    c[:, 2] = 0.3 * np.sin(3 * c[:, 0])
    return morton_sort(c)


def _bknn_case(case, rs):
    """(query, support, support_valid, query_valid) of a named case."""
    B = 2
    if case == "self duplicates":               # d = 0 everywhere: the floor
        S = Q = 5000                            # not a multiple of 128
        sup = np.stack([_sorted_cloud(rs, S) for _ in range(B)])
        sup[:, 1001:1011] = sup[:, 1000:1001]   # exact duplicates across rows
        sup[:, 1300] = sup[:, 1300 - 128]       # the same column, next row
        sv = rs.rand(B, S) > 0.05
        sv[:, 400:530] = False                  # invalid points inside windows
        qry, qv = sup, sv.copy()
    elif case in ("ratio 3", "ratio 1/3"):
        S = 6000 if case == "ratio 3" else 2100
        Q = 2000 if case == "ratio 3" else 6300
        sup = np.stack([_sorted_cloud(rs, S) for _ in range(B)])
        sv = np.ones((B, S), bool)
        sv[1, -300:] = False                    # padding past the valid count
        sv[:, 700:760] = False
        qry = np.stack([_sorted_cloud(rs, Q) for _ in range(B)])
        qv = np.ones((B, Q), bool)
        qv[0, -50:] = False
    elif case == "mirror ties":                 # equal truncated distances
        S, Q = 4096, 1024
        base = _sorted_cloud(rs, S // 2)
        sup = np.concatenate([base, base * np.float32(-1)])
        sup = np.stack([morton_sort(sup)] * B)
        sv = np.ones((B, S), bool)
        qry = np.zeros((B, Q, 3), np.float32)   # the origin: mirror pairs tie
        qry[:, ::2] = sup[:, :2 * Q:4]
        qv = np.ones((B, Q), bool)
    else:
        raise KeyError(case)
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (qry, sup, sv, qv))


@pytest.mark.parametrize("win_rows", [16, 64])
@pytest.mark.parametrize("case,k,radius", [
    ("self duplicates", 16, None), ("self duplicates", 1, 0.05),
    ("ratio 3", 16, 0.1), ("ratio 3", 128, None),
    ("ratio 1/3", 16, 0.08), ("mirror ties", 16, None),
    ("mirror ties", 128, 0.3)])
def test_bknn_kernel_model_matches_plain(case, k, radius, win_rows):
    """The kernel's algorithm gives the plain version's bits: distances,
    validity and indices (those of invalid slots too); windows of 16 and of
    up to 64 rows (16 or 32 here) on grids of 17-47 rows, so starts clip
    at both ends."""
    rs = np.random.RandomState(sum(map(ord, case)) + k)
    args = _bknn_case(case, rs) + (k, radius, win_rows)
    got = _bknn_kernel_model(*args)
    want = knn_cuda.banded_knn_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    d = want[0]
    if case == "self duplicates":
        assert (d == d[d > 0].min()).any()      # floored zero distances
    NR, LW = knn_cuda.window_rows(args[1].shape[1], win_rows)
    r0 = knn_cuda.window_starts(args[2], args[3], NR, LW)
    assert int(r0.min()) == 0 and int(r0.max()) == ((NR - LW) // 8) * 8


def _banded_calls(cfg):
    """(B, Q, S, LW) of the banded kNN calls of a preset's pyramid: the
    level searches and both pools, where the dispatch bands them."""
    st = cfg.static
    l0, l1, l2 = st.points_l0, st.points_l1, st.points_l2
    shapes = [(l0, l0), (l1, l1), (l2, l2), (l1, l0), (l2, l1)]
    out = []
    for Q, S in shapes:
        if (knn_cuda.banded_supported(S)
                and neighbors.knn_route(S, st.knn_band or 4096) == "banded"):
            wr, _ = knn_cuda.banded_win_rows(S, st.knn_band or 4096)
            out.append((2, Q, S, knn_cuda.window_rows(S, wr)[1]))
    return out


@pytest.mark.parametrize("make_cfg,n_calls", [(threedmatch_cfg, 4),
                                              (kitti_cfg, 5), (tiny_cfg, 0)])
def test_bknn_plan_at_preset_shapes(make_cfg, n_calls):
    """At every banded call shape (and, at the tiny plan, every shape the
    kernel takes): whole warps, shared memory within 227 KB, and every
    tile's window whole 8-row chunks inside the grid, at the valid-count
    ratios 1, 3 and 1/3."""
    calls = _banded_calls(make_cfg())
    assert len(calls) == n_calls
    if not calls:                               # tiny: 512 points, 4 rows
        calls = [(2, 512, 4096, 16), (2, 100, 2048, 16)]
    for B, Q, S, LW in calls:
        threads, ring, smem = knn_cuda.bknn_plan(B, Q, S, LW)
        assert threads % 32 == 0 and threads == 256
        assert smem == knn_cuda.bknn_smem_bytes(ring) <= 227 * 1024
        assert LW % 8 == 0
        NR = -(-S // 128)
        for ns, nq in ((S, Q), (S, Q * 3), (S // 3, Q)):
            for t in range(-(-Q // 32)):
                r0 = _window_start(t, ns, nq, NR, LW)
                assert r0 % 8 == 0 and 0 <= r0 and r0 + LW <= NR


def test_bknn_plan_refuses():
    with pytest.raises(ValueError):
        knn_cuda.bknn_plan(2, 1000, 4096, 24)          # not 16-row aligned
    with pytest.raises(ValueError):
        knn_cuda.bknn_plan(2, 1000, 1024, 16)          # window past the grid
    with pytest.raises(ValueError):
        knn_cuda.bknn_plan(2, 1000, (1 << 16) + 1, 64)  # ranks past 16 bits
    with pytest.raises(ValueError):
        knn_cuda.bknn_plan(2, 0, 4096, 16)
    ring = knn_cuda.BKNN_RING
    assert knn_cuda.bknn_plan(2, 30720, 30720, 64) == (
        256, ring, knn_cuda.bknn_smem_bytes(ring))


# ---------------------------------------------------------------------------
# ball sampling
# ---------------------------------------------------------------------------


def _ball_kernel_model(query, support, sv, prio, radius, k, plan):
    """csrc/ball.cu in PyTorch: the support packed into [B, G, Lp, NSB]
    grids of (x, y, z, (x*x + y*y) + z*z) and masked priorities; rows
    streamed in order, the top 2 updated only on a hit with strict
    comparisons from -1e9; each winner's point read from the packed grid."""
    QT, _, NSB, CH, _, _ = plan
    B, Q, _ = query.shape
    N = support.shape[1]
    NS = k // 2
    L = N // NS
    G, Lp = -(-NS // NSB), -(-L // CH) * CH
    grid = torch.zeros((B, G * NSB, Lp, 4))
    ugrid = torch.full((B, G * NSB, Lp), -1e9)
    pts = support.reshape(B, NS, L, 3)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    grid[:, :NS, :L] = torch.stack([x, y, z, (x * x + y * y) + z * z], -1)
    ugrid[:, :NS, :L] = torch.where(sv, prio, _f32(-1e9)).reshape(B, NS, L)
    grid = grid.transpose(1, 2)                          # [B, Lp, G*NSB, 4]
    ugrid = ugrid.transpose(1, 2)
    r2 = _f32(float(radius) ** 2)
    outs = torch.zeros((B, Q, k, 3))
    valid = torch.zeros((B, Q, k), dtype=torch.bool)
    for b in range(B):
        for q0 in range(0, Q, QT):                       # blocks over queries
            qq = query[b, q0:q0 + QT]
            qx, qy, qz = (qq[:, d, None] for d in range(3))
            rhs = r2 - ((qx * qx + qy * qy) + qz * qz)
            n = qq.shape[0]
            v1 = torch.full((n, G * NSB), -1e9)
            v2 = v1.clone()
            l1 = torch.zeros((n, G * NSB), dtype=torch.long)
            l2 = l1.clone()
            for l in range(L):
                p, u = grid[b, l], ugrid[b, l]
                t = (-2.0 * qx) * p[:, 0] + p[:, 3]
                t = t + (-2.0 * qy) * p[:, 1]
                t = t + (-2.0 * qz) * p[:, 2]
                enter = (t <= rhs) & (u > v2)
                first = enter & (u > v1)
                second = enter & ~first
                v2 = torch.where(first, v1, torch.where(second, u, v2))
                l2 = torch.where(first, l1, torch.where(second, l, l2))
                v1 = torch.where(first, u.expand_as(v1), v1)
                l1 = torch.where(first, l, l1)
            for r, (v, li) in enumerate(((v1, l1), (v2, l2))):
                ok = v[:, :NS] > -5e8
                seg = torch.arange(NS)
                p = grid[b][li[:, :NS], seg][..., :3]
                outs[b, q0:q0 + n, r * NS:(r + 1) * NS] = torch.where(
                    ok[..., None], p, _f32(0.0))
                valid[b, q0:q0 + n, r * NS:(r + 1) * NS] = ok
    return outs, valid


def _ball_inputs(case, rs, B, N, Q, k, radius):
    NS = k // 2
    L = N // NS
    sup = rs.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    sv = rs.rand(B, N) > 0.15                            # in-ball invalid points
    prio = rs.rand(B, N).astype(np.float32)
    q = sup[:, rs.choice(N, Q, replace=False)].copy()
    if case == "ties":
        prio = (np.round(prio * 3) / 3).astype(np.float32)
    sup[:, :L] = 50.0                                    # segment 0: none in ball
    sup[:, L:2 * L] = 50.0                               # segment 1: one
    sup[:, L + 3] = q[:, 0]
    sv[:, L + 3] = True
    return tuple(torch.from_numpy(a) for a in (q, sup, sv, prio)) + (radius, k)


@pytest.mark.parametrize("case,B,N,Q,k", [
    ("distinct", 2, 4096, 37, 64), ("ties", 2, 4096, 37, 64),
    ("ties", 1, 2400, 20, 600), ("distinct", 2, 1536, 9, 6)])
def test_ball_kernel_model_matches_plain(case, B, N, Q, k):
    """The kernel's algorithm (packed |s|^2, update-on-hit top 2) gives the
    plain version's bits, with distinct and tied priorities, in-ball
    invalid points, a segment with no in-ball point and one with one; k =
    600 takes ragged slices of segments (NS = 300), k = 6 three segments in
    one warp; 4 and 8 queries a thread, slices of 32 and 256 segments."""
    rs = np.random.RandomState(N + Q)
    args = _ball_inputs(case, rs, B, N, Q, k, 0.5)
    L, NS = N // (k // 2), k // 2
    want = geom_cuda.ball_sample_points_plain(*args)
    for qt in geom_cuda.BALL_QUERIES:
        for nsb in (32, 256):
            plan = ball_variant(NS, qt, nsb, geom_cuda.BALL_RING)
            got = _ball_kernel_model(*args, plan=plan)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    v = want[1]
    assert not v[:, :, 0].any() and not v[:, :, NS].any()   # segment 0
    assert v[:, 0, 1].all() and not v[:, 0, NS + 1].any()   # segment 1
    assert v.any() and not v.all()


@pytest.mark.parametrize("make_cfg,Q", [(threedmatch_cfg, 1500),
                                        (threedmatch_cfg, 512),
                                        (kitti_cfg, 1500), (tiny_cfg, 64),
                                        (tiny_cfg, 13)])
def test_ball_plan_at_preset_shapes(make_cfg, Q):
    """At both presets' inference shapes (1500 keypoints a cloud), the
    training shape (512) and tiny_cfg's: whole warps, every segment in one
    slice, blocks that cover Q, chunk sizes the bulk copy takes, shared
    memory within 227 KB, a block for each of the 132 SMs at Q >= 512."""
    cfg = make_cfg()
    k = cfg.patch.num_points_per_patch
    N = cfg.static.raw_points
    NS = k // 2
    QT, QG, NSB, CH, ring, smem = geom_cuda.ball_plan(2, Q, N // NS, NS)
    assert QT in geom_cuda.BALL_QUERIES
    assert NSB % 32 == 0 and QG * NSB <= geom_cuda.BALL_THREADS
    G = -(-NS // NSB)
    assert G * NSB >= NS > (G - 1) * NSB
    blocks = -(-Q // (QG * QT))
    assert blocks * QG * QT >= Q > (blocks - 1) * QG * QT
    if Q >= 512:
        assert 2 * G * blocks >= 132
    assert CH % 4 == 0 and (CH * NSB * 4) % 16 == 0
    assert smem == geom_cuda.ball_smem_bytes(NSB, CH, ring) <= 227 * 1024


def test_ball_plan_refuses():
    with pytest.raises(ValueError):
        geom_cuda.ball_plan(2, 100, 1 << 17, 1)        # rows past 16 bits
    with pytest.raises(ValueError):
        geom_cuda.ball_plan(2, 100, 64, 0)
    with pytest.raises(ValueError):
        geom_cuda.ball_plan(0, 100, 64, 256)
    with pytest.raises(ValueError):
        geom_cuda.ball_plan(2, 0, 64, 256)


# ---------------------------------------------------------------------------
# banded 1-NN
# ---------------------------------------------------------------------------


def _bnn1_kernel_model(query, support, sv, qv, queries):
    """csrc/bnn1.cu in PyTorch: the support packed as (x, y, z, pen); a
    block a tile copies its 16 window rows [r0, r0 + 16) of the packed grid;
    a warp takes ``queries`` of the tile's queries (past Q, query 0);
    keys compared as floats from +inf, each column's winner, the
    candidates' min over a lane's columns (lane l takes columns l, l + 32,
    l + 64, l + 96), then over the warp's lanes."""
    B, Q, _ = query.shape
    S = support.shape[1]
    NR, LW = knn_cuda.window_rows(S, 16)
    assert LW == 16 and 32 % queries == 0
    packed = torch.zeros((B, NR * 128, 4))
    packed[..., 3] = 1e9
    packed[:, :S, :3] = support
    packed[:, :S, 3] = torch.where(sv, _f32(0.0), _f32(1e9))
    n_tiles = -(-Q // 32)
    keys = torch.full((B, Q), -1, dtype=torch.int32)
    cols = torch.arange(128, dtype=torch.int32)
    for b in range(B):
        ns, nq = int(sv[b].sum()), int(qv[b].sum())
        for t in range(n_tiles):                            # one block
            r0 = _window_start(t, ns, nq, NR, 16)
            assert r0 % 8 == 0 and 0 <= r0 and r0 + 16 <= NR
            win = packed[b, r0 * 128:(r0 + 16) * 128].reshape(16, 128, 4)
            qi = torch.arange(t * 32, t * 32 + 32)
            q = query[b, torch.where(qi < Q, qi, 0)]
            q = q.reshape(32 // queries, queries, 1, 3)      # [warp, query]
            m = torch.full((32 // queries, queries, 128), INF)
            for row in range(16):
                p = win[row]
                dx = q[..., 0] - p[:, 0]
                dy = q[..., 1] - p[:, 1]
                dz = q[..., 2] - p[:, 2]
                d = (dx * dx + dy * dy) + dz * dz
                d = torch.maximum(d + p[:, 3], _f32(1e-30))
                key = (d.view(torch.int32) & ~0x3F) | row
                m = torch.minimum(m, key.view(torch.float32))
            k = m.view(torch.int32)
            rank = (r0 + (k & 0x3F)) * 128 + cols
            cand = (k & ~0xFFFF) | rank                     # [warp, query, col]
            lane_best = cand.reshape(*cand.shape[:2], 4, 32).amin(2)
            best = lane_best.amin(-1).reshape(32)
            n = min(32, Q - t * 32)
            keys[b, t * 32:t * 32 + n] = best[:n]
    assert (keys >= 0).all()
    d, idx, _ = knn_cuda.decode(keys, S)
    return d, idx.to(torch.int32)


def _bnn1_case(case, rs):
    """(query, support, support_valid, query_valid) of a named case."""
    B = 2
    if case == "self duplicates":              # d = 0: the floor; ties
        S = Q = 4000                           # ragged: not a multiple of 32
        sup = np.stack([_sorted_cloud(rs, S) for _ in range(B)])
        sup[:, 1001:1011] = sup[:, 1000:1001]  # duplicates across columns
        sup[:, 1300] = sup[:, 1300 - 128]      # the same column, next row
        sv = rs.rand(B, S) > 0.05
        sv[:, 400:530] = False
        qry, qv = sup.copy(), sv.copy()
    elif case in ("ratio 3", "ratio 1/3"):
        S = 6000 if case == "ratio 3" else 2100
        Q = 2000 if case == "ratio 3" else 6300
        sup = np.stack([_sorted_cloud(rs, S) for _ in range(B)])
        sv = np.ones((B, S), bool)
        sv[1, -300:] = False
        sv[:, 700:760] = False
        qry = np.stack([_sorted_cloud(rs, Q) for _ in range(B)])
        qv = np.ones((B, Q), bool)
        qv[0, -50:] = False
    elif case == "mirror ties":                # equal distances at the origin
        S, Q = 4096, 1000
        base = _sorted_cloud(rs, S // 2)
        sup = np.stack([morton_sort(np.concatenate(
            [base, base * np.float32(-1)]))] * B)
        sv = np.ones((B, S), bool)
        qry = np.zeros((B, Q, 3), np.float32)
        qry[:, ::2] = sup[:, :2 * Q:4]
        qv = np.ones((B, Q), bool)
    elif case == "truncation ties":
        # per query, two points of one column (rows 3 and 9 of its window)
        # whose distances differ only below the 16 truncated bits: the
        # column keeps the nearer (row 9), a one-level min over rank keys
        # would take row 3
        S, Q = 2048, 64
        sup = (rs.uniform(-1, 1, (B, S, 3)) * 50 + 100).astype(np.float32)
        sv = np.ones((B, S), bool)
        grid = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1)
        qry = np.stack([grid.reshape(Q, 3) * 10.0
                        + rs.uniform(-1, 1, (Q, 3)) for _ in range(B)])
        qry = qry.astype(np.float32)           # 10 apart: its own pair wins
        qv = np.ones((B, Q), bool)
        for b in range(B):
            for qi in range(Q):
                c = qi                              # a column of its own
                d = rs.uniform(0.1, 0.5)
                u = rs.normal(size=3)
                u = (u / np.linalg.norm(u)).astype(np.float32)
                near = qry[b, qi] + np.float32(d) * u
                far = qry[b, qi] + np.float32(d * (1 + 2 ** -16)) * u
                sup[b, 3 * 128 + c] = far
                sup[b, 9 * 128 + c] = near
    elif case == "all invalid":                # no valid support, no valid query
        S, Q = 2600, 700
        sup = np.stack([_sorted_cloud(rs, S) for _ in range(B)])
        sv = np.zeros((B, S), bool)
        qry = np.stack([_sorted_cloud(rs, Q) for _ in range(B)])
        qv = np.zeros((B, Q), bool)
        qv[1] = True                           # cloud 1: valid queries only
    else:
        raise KeyError(case)
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (qry, sup, sv, qv))


BNN1_CASES = ["self duplicates", "ratio 3", "ratio 1/3", "mirror ties",
              "truncation ties", "all invalid"]


@pytest.mark.parametrize("case", BNN1_CASES)
def test_bnn1_kernel_model_matches_plain(case):
    """The kernel's algorithm gives the plain version's bits at every plan
    of the sweep (4, 8 and 16 queries a thread)."""
    rs = np.random.RandomState(sum(map(ord, case)))
    args = _bnn1_case(case, rs)
    want = knn_cuda.banded_nn1_plain(*args)
    plans = {knn_cuda.bnn1_plan(2, args[0].shape[1], args[1].shape[1])}
    for plan in sorted(plans | set(BNN1_ALTERNATIVES)):
        got = _bnn1_kernel_model(*args, plan)
        for a, b in zip(got, want):
            assert torch.equal(a, b), plan
    d, i = want
    NR, LW = knn_cuda.window_rows(args[1].shape[1], 16)
    r0 = knn_cuda.window_starts(args[2], args[3], NR, LW)
    if case == "self duplicates":
        assert (d == d[d > 0].min()).any() and float(d.min()) < 1e-29
    if case in ("ratio 3", "ratio 1/3"):               # clipped at both ends
        assert int(r0.min()) == 0 and int(r0.max()) == ((NR - LW) // 8) * 8
    if case == "truncation ties":
        # row 9 wins although row 3 ties it at 16 bits and has the lower rank
        assert int(r0.max()) == 0
        cols = torch.arange(64, dtype=torch.int32)
        assert torch.equal(i, (9 * 128 + cols).expand(2, 64))
        one_level = _one_level_bnn1(*args)
        assert not torch.equal(one_level, i)
    if case == "all invalid":
        assert (d > 5e8).all()                         # truncated 1e9 + d2


def _one_level_bnn1(query, support, sv, qv):
    """The min over (bits(d2) & ~0xFFFF) | rank of the whole window in one
    level: not the contract (it shows what the two levels keep)."""
    B, Q, _ = query.shape
    S = support.shape[1]
    NR, LW = knn_cuda.window_rows(S, 16)
    r0 = knn_cuda.window_starts(sv, qv, NR, LW)
    keys = knn_cuda._window_keys(query, knn_cuda.support_grid(support, sv, NR),
                                 r0, 0, r0.shape[1], LW)  # [B, T, 32, LW, 128]
    rows = torch.arange(LW, dtype=torch.int32)[:, None]
    cols = torch.arange(128, dtype=torch.int32)
    rank = (r0[:, :, None, None, None] + rows) * 128 + cols
    one = ((keys & ~0xFFFF) | rank).reshape(B, -1, LW * 128).amin(-1)
    return (one & 0xFFFF)[:, :Q].to(torch.int32)


def _bnn1_calls(cfg):
    """(B, Q, S) of the banded 1-NN calls of a preset: the l0 -> l1
    upsample and, where the band restricts it, the training sampler."""
    st = cfg.static
    calls = []
    if neighbors.nearest_route(st.points_l1, st.knn_band) == "banded":
        calls.append((2, st.points_l0, st.points_l1))
    if neighbors.nearest_route(st.points_l0, st.knn_band) == "banded":
        calls.append((1, st.points_l0, st.points_l0))
    return calls


@pytest.mark.parametrize("make_cfg,n_calls", [(threedmatch_cfg, 2),
                                              (kitti_cfg, 2), (tiny_cfg, 0)])
def test_bnn1_plan_at_preset_shapes(make_cfg, n_calls):
    """At every banded 1-NN call of the presets (and the shapes the banded
    tests use): an instantiated queries a thread that splits a tile into
    whole warps, and at the valid-count ratios of the calls and of 3 and
    1/3, every tile's window 16 rows inside the grid in two 8-row
    chunks."""
    calls = _bnn1_calls(make_cfg())
    assert len(calls) == n_calls
    if not calls:
        calls = [(2, 4096, 2048), (2, 2048, 4096)]
    for B, Q, S in calls:
        QT = knn_cuda.bnn1_plan(B, Q, S)
        assert QT in knn_cuda.BNN1_QUERIES_ALLOWED and 32 % QT == 0
        NR = -(-S // 128)
        for ns, nq in ((S, Q), (S, 3 * Q), (S // 3, Q)):
            for t in range(-(-Q // 32)):
                r0 = _window_start(t, ns, nq, NR, 16)
                assert r0 % 8 == 0 and 0 <= r0 and r0 + 16 <= NR


def test_bnn1_plan_refuses():
    with pytest.raises(ValueError):
        knn_cuda.bnn1_plan(2, 1000, 1500)              # fewer than 16 rows
    with pytest.raises(ValueError):
        knn_cuda.bnn1_plan(2, 1000, (1 << 16) + 1)     # ranks past 16 bits
    with pytest.raises(ValueError):
        knn_cuda.bnn1_plan(2, 0, 4096)
    with pytest.raises(ValueError):
        knn_cuda.bnn1_plan(0, 10, 4096)
    assert knn_cuda.bnn1_plan(2, 30720, 10240) == knn_cuda.BNN1_QUERIES


# ---------------------------------------------------------------------------
# exact 1-NN
# ---------------------------------------------------------------------------


def _nearest_kernel_model(query, support, valid, plan):
    """csrc/nearest.cu in PyTorch: a cluster of P CTAs a group of 32*QT
    queries (query j*32 + lane of the group in lane `lane`'s slot j), CTA r
    staging the r-th slice of the support as 8 warp runs of a multiple of 4
    points, invalid and padding points at +inf; each lane scans its warp's
    run in index order from (1e9, 0) with a strict compare; 64-bit keys
    (bits(d2) << 32) | idx merged over the warps, then over the cluster."""
    QT, P = plan
    B, Q, _ = query.shape
    S = support.shape[1]
    W = geom_cuda.NEAREST_WARPS
    groups = -(-Q // (32 * QT))
    slice_ = -(-S // P)
    run = -(-(-(-slice_ // W)) // 4) * 4
    # staged[b, r, w, i]: point s = r*slice + w*run + i if in the slice
    s = (torch.arange(P)[:, None, None] * slice_
         + torch.arange(W)[None, :, None] * run + torch.arange(run))
    r_end = torch.clamp((torch.arange(P) + 1) * slice_, max=S)[:, None, None]
    inside = s < r_end
    sc = torch.where(inside, s, 0)
    pts = support[:, sc]                                  # [B, P, W, run, 3]
    ok = inside & valid[:, sc]
    pts = torch.where(ok[..., None], pts, _f32(INF))
    # queries [B, groups, QT, 32]
    qi = (torch.arange(groups)[:, None, None] * 32 * QT
          + torch.arange(QT)[None, :, None] * 32 + torch.arange(32))
    q = query[:, torch.where(qi < Q, qi, 0)]              # [B, G, QT, 32, 3]
    q = q[:, :, None, None]                               # [B, G, 1, 1, QT, 32, 3]
    bd = torch.full((B, groups, P, W, QT, 32), 1e9)
    bi = torch.zeros((B, groups, P, W, QT, 32), dtype=torch.int64)
    for i in range(run):
        p = pts[:, :, :, i][:, None, :, :, None, None]    # [B, 1, P, W, 1, 1, 3]
        dx = q[..., 0] - p[..., 0]
        dy = q[..., 1] - p[..., 1]
        dz = q[..., 2] - p[..., 2]
        d = (dx * dx + dy * dy) + dz * dz
        lt = d < bd
        bd = torch.where(lt, d, bd)
        bi = torch.where(lt, s[:, :, i][None, None, :, :, None, None], bi)
    key = (bd.view(torch.int32).to(torch.int64) << 32) | bi
    key = key.amin(3).amin(2)                             # warps, then CTAs
    key = key.reshape(B, groups * 32 * QT)[:, :Q]
    return ((key >> 32).to(torch.int32).view(torch.float32),
            (key & 0xFFFFFFFF).to(torch.int32))


def _nearest_case(case, rs):
    """(query, support, valid) of a named case."""
    if case == "duplicates":                   # d = 0 and ties: lowest index
        B, S, Q = 2, 3072, 1000
        sup = rs.uniform(-1, 1, (B, S, 3)).astype(np.float32)
        sup[:, 2000:2010] = sup[:, 5:6]        # exact duplicates, far apart
        sup[:, 700] = sup[:, 5]
        valid = rs.rand(B, S) > 0.1
        valid[:, [5, 700, 2000]] = [False, True, True]
        qry = sup[:, rs.choice(S, Q, replace=False)].copy()
        qry[:, 0] = sup[:, 5]
    elif case == "mirror ties":                # queries at the origin
        B, S, Q = 2, 2900, 333                 # ragged Q and S
        half = rs.uniform(-1, 1, (B, S // 2, 3)).astype(np.float32)
        sup = np.concatenate([half, -half], 1)
        sup = np.concatenate([sup, np.zeros((B, S - sup.shape[1], 3), np.float32) + 7], 1)
        valid = np.ones((B, S), bool)
        qry = rs.uniform(-1, 1, (B, Q, 3)).astype(np.float32)
        qry[:, ::3] = 0.0
    elif case == "all invalid":
        B, S, Q = 2, 1000, 70
        sup = rs.uniform(-1, 1, (B, S, 3)).astype(np.float32)
        valid = np.zeros((B, S), bool)
        valid[1, 999] = True                   # cloud 1: only its last point
        qry = rs.uniform(-1, 1, (B, Q, 3)).astype(np.float32)
    elif case == "tiny":
        B, S, Q = 3, 5, 9
        sup = rs.uniform(-1, 1, (B, S, 3)).astype(np.float32)
        valid = rs.rand(B, S) > 0.3
        qry = rs.uniform(-1, 1, (B, Q, 3)).astype(np.float32)
    else:
        raise KeyError(case)
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (qry, sup, valid))


@pytest.mark.parametrize("case", ["duplicates", "mirror ties", "all invalid",
                                  "tiny"])
def test_nearest_kernel_model_matches_plain(case):
    """The kernel's algorithm gives the plain version's bits at every plan
    of the sweep (1 to 8 queries a thread, clusters of 1 to 8 CTAs, runs
    padded with +inf points)."""
    rs = np.random.RandomState(sum(map(ord, case)))
    args = _nearest_case(case, rs)
    want = geom_cuda.nearest_plain(*args)
    B, Q, S = args[0].shape[0], args[0].shape[1], args[1].shape[1]
    plans = {geom_cuda.nearest_plan(B, Q, S)} | set(NEAREST_ALTERNATIVES)
    for plan in sorted(plans):
        got = _nearest_kernel_model(*args, plan)
        for a, b in zip(got, want):
            assert torch.equal(a, b), plan
    d, i = want
    if case == "duplicates":
        assert float(d[:, 0].max()) == 0.0 and (i[:, 0] == 700).all()
    if case == "all invalid":
        assert (d[0] == 1e9).all() and (i[0] == 0).all() and (i[1] == 999).all()


def _nearest_calls(cfg):
    """(B, Q, S) of the exact 1-NN calls of a preset's pyramid."""
    st = cfg.static
    out = []
    for Q, S in ((st.points_l0, st.points_l1), (st.points_l1, st.points_l2)):
        if neighbors.nearest_route(S, st.knn_band) == "exact":
            out.append((2, Q, S))
    return out


@pytest.mark.parametrize("make_cfg,n_calls", [(threedmatch_cfg, 1),
                                              (kitti_cfg, 1), (tiny_cfg, 2)])
def test_nearest_plan_at_preset_shapes(make_cfg, n_calls):
    """At the presets' exact 1-NN calls (and at ``knn_band = 0``, where
    both upsamples take it): a grid of at least four CTAs an SM on the
    preset calls, runs of at least 32 points a warp where the cluster
    splits, a slice the kernel's shared memory holds."""
    cfg = make_cfg()
    calls = _nearest_calls(cfg)
    assert len(calls) == n_calls
    unbanded = cfg.replace(static=dataclasses.replace(cfg.static, knn_band=0))
    for B, Q, S in calls + _nearest_calls(unbanded):
        QT, P = geom_cuda.nearest_plan(B, Q, S)
        assert QT in geom_cuda.NEAREST_QUERIES_ALLOWED and 1 <= P <= 8
        assert -(-S // P) <= geom_cuda.NEAREST_MAX_SLICE
        ctas = B * -(-Q // (32 * QT)) * P
        if make_cfg is not tiny_cfg:
            assert ctas >= 4 * 132
        if P > 1:
            assert S // (P * 8) >= 32


def test_nearest_slice_cap_matches_the_source():
    """The plan's cap on a CTA's slice is the kernel's own (csrc/nearest.cu
    checks it against its shared-memory layout at compile time)."""
    import re
    src = (cuda.CSRC / "nearest.cu").read_text()
    cap = re.search(r"constexpr int kMaxSlice = (\d+);", src)
    assert cap and int(cap.group(1)) == geom_cuda.NEAREST_MAX_SLICE


def test_nearest_plan_refuses():
    with pytest.raises(ValueError):
        geom_cuda.nearest_plan(2, 100, 200000)        # no cluster holds it
    with pytest.raises(ValueError):
        geom_cuda.nearest_plan(2, 0, 100)
    with pytest.raises(ValueError):
        geom_cuda.nearest_plan(0, 10, 100)
    assert geom_cuda.nearest_plan(2, 10240, 3072) == (2, 2)
    assert geom_cuda.nearest_plan(2, 20480, 6144) == (4, 2)
    assert geom_cuda.nearest_plan(1, 30720, 30720) == (4, 4)
