"""PyTorch models of the Hopper designs of the banded kNN (``csrc/bknn.cu``)
and ball sampling (``csrc/ball.cu``), held bit for bit to the plain
versions, and their launch plans at the presets' call shapes.

A CUDA kernel cannot run here; each model repeats its kernel's algorithm
(packing, staging order, comparisons and updates) in PyTorch so that the
reordering is shown to keep the plain version's bits on the CPU.  The plain
versions are held to the Pallas kernels by ``tests/test_torch_banded.py``
and ``tests/test_torch_kernels.py``; the kernels to the plain versions on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from buffer_tpu_torch.config import kitti_cfg, threedmatch_cfg, tiny_cfg
from buffer_tpu_torch.data.preprocess import morton_sort
from buffer_tpu_torch.kernels import geom_cuda, knn_cuda
from buffer_tpu_torch.ops import neighbors
from buffer_tpu_torch.utils.plan_sweep import ball_variant

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
