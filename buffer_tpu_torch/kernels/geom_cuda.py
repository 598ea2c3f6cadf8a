"""Geometry kernels: exact 1-NN, ball sampling (coordinate planes for the
inference front, stacked points for the training front) and the fused SPT
front.

Counterparts of ``buffer_tpu/kernels/geom_pallas.py``.  Each wrapper takes
its plain PyTorch version for CPU tensors only; a CUDA tensor goes to the
hand-written kernel in ``csrc/`` or raises.  The plain versions repeat the
kernels' arithmetic operation for operation (no fused multiply-adds
anywhere), so on the card kernel and plain version agree bit for bit.
None of the kernels has a backward: 1-NN and ball sampling return indices
or copies of input points, and the SPT front serves inference only.  Every
wrapper raises when an input asks for a gradient.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from buffer_tpu_torch.core import gridmath
from buffer_tpu_torch.kernels import cuda
from buffer_tpu_torch.kernels.cuda import F, I, P

BIG = 1e9

NEAREST = cuda.register(cuda.Kernel(
    "nearest", "buffer_tpu_torch/csrc/nearest.cu", "nearest_launch",
    [P, P, P, I, I, I, I, I, P, P, P],
    "buffer_tpu/kernels/geom_pallas.py:269"))
BALL = cuda.register(cuda.Kernel(
    "ball_sample", "buffer_tpu_torch/csrc/ball.cu", "ball_launch",
    [P] * 4 + [I] * 4 + [F] + [I] * 6 + [P] * 7,
    "buffer_tpu/kernels/geom_pallas.py:182"))
BALL_POINTS = cuda.register(cuda.Kernel(
    "ball_sample_points", "buffer_tpu_torch/csrc/ball.cu", "ball_points_launch",
    [P] * 4 + [I] * 4 + [F] + [I] * 6 + [P] * 5,
    "buffer_tpu/kernels/geom_pallas.py:115"))
SPT = cuda.register(cuda.Kernel(
    "spt_pooled", "buffer_tpu_torch/csrc/spt.cu", "spt_launch",
    [P] * 12 + [I, I, I, I, I, I, F, I, I, I, I, P, P],
    "buffer_tpu/kernels/geom_pallas.py:419"))


# ---------------------------------------------------------------------------
# exact 1-NN
# ---------------------------------------------------------------------------


def nearest_plain(query: torch.Tensor, support: torch.Tensor,
                  valid: torch.Tensor, chunk: int = 4096
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query [B, Q, 3], support [B, S, 3], valid [B, S] -> (d2 [B, Q],
    idx [B, Q] int32); the lowest index wins a tie, invalid points never
    win, a query with no valid support gets (1e9, 0)."""
    B, Q, _ = query.shape
    d_out = torch.empty((B, Q), dtype=torch.float32, device=query.device)
    i_out = torch.empty((B, Q), dtype=torch.int32, device=query.device)
    for b in range(B):
        s = support[b]
        for q0 in range(0, Q, chunk):
            q = query[b, q0:q0 + chunk]
            dx = q[:, None, 0] - s[None, :, 0]
            dy = q[:, None, 1] - s[None, :, 1]
            dz = q[:, None, 2] - s[None, :, 2]
            d = dx * dx + dy * dy + dz * dz
            d = torch.where(valid[b][None, :], d, torch.full_like(d, BIG))
            i = torch.argmin(d, dim=1)
            m = torch.gather(d, 1, i[:, None])[:, 0]
            d_out[b, q0:q0 + chunk] = m
            i_out[b, q0:q0 + chunk] = i.to(torch.int32)
    return d_out, i_out


NEAREST_THREADS = 256        # csrc/nearest.cu kThreads: 8 warps a CTA
NEAREST_WARPS = NEAREST_THREADS // 32
NEAREST_QUERIES_ALLOWED = (1, 2, 4, 8)   # csrc/nearest.cu's instantiations
NEAREST_CLUSTER = 2          # CTAs a cluster (utils/plan_sweep.py)
NEAREST_MAX_CLUSTER = 8      # the portable cluster size
NEAREST_TARGET_CTAS = 4 * 132   # four CTAs for each of the H100's SMs
NEAREST_MIN_RUN = 32         # a warp scans no fewer support points
NEAREST_MAX_SLICE = 12288    # csrc/nearest.cu kMaxSlice: points a CTA stages


def nearest_plan(B: int, Q: int, S: int) -> Tuple[int, int]:
    """(queries a thread, CTAs a cluster) of the exact 1-NN over B clouds
    of Q queries and S support points.  A cluster takes 32*queries queries
    of one cloud and splits the support among its CTAs: NEAREST_CLUSTER
    of them (one when that leaves a warp fewer than NEAREST_MIN_RUN
    points), doubled until a CTA's slice is at most NEAREST_MAX_SLICE
    points (what its shared memory holds); then the most queries a thread,
    of 4, 2 and 1, that still give the grid NEAREST_TARGET_CTAS.  Raises
    on a support no cluster takes."""
    if B < 1 or Q < 1 or S < 1:
        raise ValueError(f"nearest: no plan for B={B}, Q={Q}, S={S}")
    P = NEAREST_CLUSTER
    if S // (P * NEAREST_WARPS) < NEAREST_MIN_RUN:
        P = 1
    while P <= NEAREST_MAX_CLUSTER and -(-S // P) > NEAREST_MAX_SLICE:
        P *= 2
    if P > NEAREST_MAX_CLUSTER:
        raise ValueError(f"nearest: a support of {S} points does not fit a "
                         "cluster's shared memory")
    qt = next((q for q in (4, 2) if B * -(-Q // (32 * q)) * P
               >= NEAREST_TARGET_CTAS), 1)
    return qt, P


def nearest_launcher(query, support, valid, outs, plan=None):
    """The wrapper's preparation (contiguous inputs, the mask as bytes
    without a copy, the plan), returning a function that makes one launch
    of ``csrc/nearest.cu`` into ``outs`` (d2, idx);
    ``utils/plan_sweep.py`` passes other plans."""
    B, Q, _ = query.shape
    S = support.shape[1]
    if Q == 0 or S == 0 or support.shape[0] != B or valid.shape != (B, S):
        raise ValueError(f"nearest: bad shapes {tuple(query.shape)}, "
                         f"{tuple(support.shape)}, {tuple(valid.shape)}")
    plan = nearest_plan(B, Q, S) if plan is None else plan
    q = query.float().contiguous()
    s = support.float().contiguous()
    v = valid.contiguous().to(torch.bool).view(torch.uint8)
    cuda.check_cuda("nearest", q, s, v, *outs)
    args = (q.data_ptr(), s.data_ptr(), v.data_ptr(), B, Q, S, *plan,
            *(o.data_ptr() for o in outs), cuda.stream_handle(q))

    def launch():
        NEAREST.launch(*args)

    launch.tensors = (q, s, v, outs)  # alive while it is
    return launch


def nearest_cuda(query: torch.Tensor, support: torch.Tensor,
                 valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN of :func:`nearest_plain`, batched over clouds, in one
    launch of ``csrc/nearest.cu`` (thread-block clusters that split the
    support, merged through distributed shared memory)."""
    cuda.check_no_grad("nearest", query, support)
    if query.device.type == "cpu":
        return nearest_plain(query, support, valid)
    B, Q, _ = query.shape
    d = torch.empty((B, Q), dtype=torch.float32, device=query.device)
    i = torch.empty((B, Q), dtype=torch.int32, device=query.device)
    nearest_launcher(query, support, valid, [d, i])()
    return d, i


# ---------------------------------------------------------------------------
# ball sampling: top-2 random priorities per support segment, coordinates out
# ---------------------------------------------------------------------------


def _ball_grids(support: torch.Tensor, u: torch.Tensor, NS: int):
    """[B, N, 3] support and [B, N] priorities -> five [B, L, NS] grids
    (x, y, z, |s|^2, u); column s is the contiguous segment s."""
    B, N, _ = support.shape
    L = N // NS
    x, y, z = support[..., 0], support[..., 1], support[..., 2]
    sn = x * x + y * y + z * z
    grid = lambda a: a.reshape(B, NS, L).transpose(1, 2).contiguous()
    return grid(x), grid(y), grid(z), grid(sn), grid(u)


def ball_sample_planes_plain(query, support, support_valid, prio, radius: float,
                             k: int, chunk: int = 64):
    """query [B, Q, 3], support [B, N, 3], support_valid [B, N], prio
    [B, N] -> (x, y, z [B, Q, k] f32, valid [B, Q, k] bool); slot order
    [firsts of the k/2 segments, seconds]; invalid slots hold 0."""
    B, Q, _ = query.shape
    N = support.shape[1]
    NS = k // 2
    L = N // NS
    r2 = torch.full((), float(radius) ** 2, dtype=torch.float32,
                    device=query.device)
    u = torch.where(support_valid, prio, torch.full_like(prio, -BIG))
    gx, gy, gz, gn, gu = _ball_grids(support, u, NS)
    outs = [torch.empty((B, Q, k), dtype=torch.float32, device=query.device)
            for _ in range(3)]
    vout = torch.empty((B, Q, k), dtype=torch.bool, device=query.device)
    neg = torch.full((), -BIG, dtype=torch.float32, device=query.device)
    for b in range(B):
        grids = [g[b].transpose(0, 1) for g in (gx, gy, gz, gn, gu)]  # [NS, L]
        sx, sy, sz, sn, su = grids
        for q0 in range(0, Q, chunk):
            q = query[b, q0:q0 + chunk]
            qx, qy, qz = q[:, 0], q[:, 1], q[:, 2]
            rhs = r2 - (qx * qx + qy * qy + qz * qz)
            t = (-2.0 * qx)[:, None, None] * sx[None] + sn[None]
            t = t + (-2.0 * qy)[:, None, None] * sy[None]
            t = t + (-2.0 * qz)[:, None, None] * sz[None]
            score = torch.where(t <= rhs[:, None, None], su[None], neg)
            a1 = torch.argmax(score, dim=-1)                       # [Qc, NS]
            v1 = torch.gather(score, -1, a1[..., None])[..., 0]
            lane = torch.arange(L, device=q.device)
            score2 = torch.where(lane[None, None, :] == a1[..., None], neg, score)
            a2 = torch.argmax(score2, dim=-1)
            v2 = torch.gather(score2, -1, a2[..., None])[..., 0]
            idx = torch.cat([a1, a2], dim=1)                       # [Qc, k]
            ok = torch.cat([v1, v2], dim=1) > -BIG / 2
            seg = torch.arange(NS, device=q.device).repeat(2)[None, :]
            for out, g in zip(outs, (sx, sy, sz)):
                val = g[seg.expand_as(idx), idx]
                out[b, q0:q0 + chunk] = torch.where(ok, val, torch.zeros_like(val))
            vout[b, q0:q0 + chunk] = ok
    return outs[0], outs[1], outs[2], vout


def ball_sample_points_plain(query, support, support_valid, prio,
                             radius: float, k: int):
    """:func:`ball_sample_planes_plain` with the coordinates stacked:
    (points [B, Q, k, 3] f32, valid [B, Q, k] bool)."""
    x, y, z, v = ball_sample_planes_plain(query, support, support_valid, prio,
                                          radius, k)
    return torch.stack([x, y, z], dim=-1), v


def _check_ball(name: str, query, support, k: int) -> None:
    N = support.shape[1]
    NS = k // 2
    if k % 2 or NS == 0 or N % NS or NS > 1024:
        raise ValueError(f"{name}: k={k} must be even with k/2 <= 1024 "
                         f"dividing N={N}")
    if query.shape[1] == 0:
        raise ValueError(f"{name}: no queries")
    cuda.check_no_grad(name, query, support)


BALL_THREADS = 256         # csrc/ball.cu kMaxThreads: threads a block
BALL_SEGMENTS = 32         # segments a block (a slice)
BALL_CHUNK_POINTS = 512    # grid points a ring chunk (rows x segments)
BALL_RING = 3              # ring chunks in flight
BALL_QUERIES = (4, 8)      # queries a thread the kernel is built for
BALL_MAX_ROWS = 1 << 16    # points a segment: a row fits 16 bits
BALL_MIN_BLOCKS = 2 * 132  # two blocks on each of the H100's 132 SMs


def ball_smem_bytes(NSB: int, CH: int, ring: int) -> int:
    """Dynamic shared memory of a ``csrc/ball.cu`` block: ``ring`` chunks of
    CH rows of its NSB segments (16 + 4 bytes a point), one mbarrier each."""
    return ring * (CH * NSB * 20 + 8)


def ball_plan(B: int, Q: int, L: int, NS: int
              ) -> Tuple[int, int, int, int, int, int]:
    """(queries a thread QT, query groups QG, segments a block NSB, rows a
    chunk CH, ring chunks, dynamic shared bytes) of ball sampling over B
    clouds of Q queries and NS segments of L points.  A block takes a slice
    of NSB = BALL_SEGMENTS segments (fewer, in whole warps, when NS is
    smaller) and QG = BALL_THREADS / NSB groups of QT queries, so the
    grids leave L2 once for every QG*QT queries; QT is 8 when the blocks
    still number BALL_MIN_BLOCKS, else 4.  Raises on what the kernel does
    not take."""
    if B < 1 or Q < 1 or not 1 <= L <= BALL_MAX_ROWS or NS < 1:
        raise ValueError(f"ball_sample: no plan for B={B}, Q={Q}, L={L}, "
                         f"NS={NS}")
    NSB = min(BALL_SEGMENTS, -(-NS // 32) * 32)
    QG = BALL_THREADS // NSB
    G = -(-NS // NSB)
    QT = 8 if B * G * -(-Q // (QG * 8)) >= BALL_MIN_BLOCKS else 4
    CH = max(4, BALL_CHUNK_POINTS // NSB // 4 * 4)
    return QT, QG, NSB, CH, BALL_RING, ball_smem_bytes(NSB, CH, BALL_RING)


def ball_launcher(kern, query, support, support_valid, prio, radius: float,
                  k: int, outs, plan=None):
    """The wrappers' preparation (contiguous inputs, the plan, the packed
    grids' scratch), returning a function that makes one call of
    ``csrc/ball.cu`` (pack, then select) into ``outs`` (the x, y, z planes
    or the stacked points, then validity as bytes) with it: the C launch
    alone, which ``chip_smoke.py`` times beside the wrapper;
    ``utils/plan_sweep.py`` passes other plans."""
    q = query.float().contiguous()
    s = support.float().contiguous()
    sv = support_valid.contiguous().to(torch.bool).view(torch.uint8)
    u = prio.float().contiguous()
    B, Q, _ = q.shape
    NS = k // 2
    L = s.shape[1] // NS
    plan = ball_plan(B, Q, L, NS) if plan is None else plan
    _, _, NSB, CH, _, _ = plan
    G, Lp = -(-NS // NSB), -(-L // CH) * CH
    grid = torch.empty((B, G, Lp, NSB, 4), dtype=torch.float32, device=q.device)
    ugrid = torch.empty((B, G, Lp, NSB), dtype=torch.float32, device=q.device)
    cuda.check_cuda(kern.name, q, s, sv, u, grid, ugrid, *outs)
    args = (q.data_ptr(), s.data_ptr(), sv.data_ptr(), u.data_ptr(), B, Q, L,
            NS, float(radius) ** 2, *plan, grid.data_ptr(), ugrid.data_ptr(),
            *(o.data_ptr() for o in outs), cuda.stream_handle(q))

    def launch():
        kern.launch(*args)

    launch.tensors = (q, s, sv, u, grid, ugrid, outs)  # alive while it is
    return launch


def ball_sample_planes_cuda(query, support, support_valid, prio,
                            radius: float, k: int):
    """Ball sampling of :func:`ball_sample_planes_plain`, batched over
    clouds, in one call of ``csrc/ball.cu`` (reference: pointnet2
    ball_query over a shuffled cloud): a pack kernel lays the support out
    as segment columns of float4 (x, y, z, |s|^2) and masked priorities,
    then each block of :func:`ball_plan` streams them once through shared
    memory for its queries and keeps each segment's top 2 on a hit."""
    _check_ball("ball_sample", query, support, k)
    if query.device.type == "cpu":
        return ball_sample_planes_plain(query, support, support_valid, prio,
                                        radius, k)
    B, Q, _ = query.shape
    outs = [torch.empty((B, Q, k), dtype=torch.float32, device=query.device)
            for _ in range(3)]
    outs.append(torch.empty((B, Q, k), dtype=torch.bool, device=query.device))
    ball_launcher(BALL, query, support, support_valid, prio, radius, k,
                  [outs[0], outs[1], outs[2], outs[3].view(torch.uint8)])()
    return tuple(outs)


def ball_sample_points_cuda(query, support, support_valid, prio,
                            radius: float, k: int):
    """Ball sampling of :func:`ball_sample_points_plain` in one call over
    all clouds: query [B, Q, 3], support [B, N, 3], support_valid and the
    priorities prio [B, N] -> (points [B, Q, k, 3], valid [B, Q, k]); k even,
    k/2 <= 1024 dividing N.  The same kernel as
    :func:`ball_sample_planes_cuda`, writing stacked points.  The points are
    copies of support points (no backward; see the module docstring)."""
    _check_ball("ball_sample_points", query, support, k)
    if query.device.type == "cpu":
        return ball_sample_points_plain(query, support, support_valid, prio,
                                        radius, k)
    B, Q, _ = query.shape
    pts = torch.empty((B, Q, k, 3), dtype=torch.float32, device=query.device)
    v = torch.empty((B, Q, k), dtype=torch.bool, device=query.device)
    ball_launcher(BALL_POINTS, query, support, support_valid, prio, radius, k,
                  [pts, v.view(torch.uint8)])()
    return pts, v


# ---------------------------------------------------------------------------
# fused SPT front
# ---------------------------------------------------------------------------


def spt_layout(S: int, voxel_sample: int):
    """(NUSE, S_eff): the segments that can win a slot and the trimmed
    patch length.  Only the first NUSE = min(voxel_sample, NSEG) of the NSEG
    segments can win, so the rows past them are dropped before the kernel
    (geom_pallas.py:455-468) and the trimmed patch has NUSE segments."""
    NSEG = max(voxel_sample, -(-S // 256))
    while S % NSEG:
        NSEG += 1
    NUSE = min(voxel_sample, NSEG)
    return NUSE, NUSE * (S // NSEG)


SPT_ANCHORS_A_THREAD = 4     # csrc/spt.cu kAT
SPT_TARGET_THREADS = 320     # a block's threads the plan aims at
SPT_MAX_THREADS = 512        # csrc/spt.cu kMaxThreads
SPT_MAX_KEYPOINTS = 8
SPT_MAX_SMEM = 96 * 1024


def spt_smem_bytes(S_eff: int, A: int, NSEG: int, KB: int) -> int:
    """Dynamic shared memory of a block of KB keypoints: the staged points
    (16 bytes each), each point's staged position (4) and the (anchor,
    segment) winners (2 each), rounded up to 16 bytes."""
    b = KB * S_eff * 16 + S_eff * 4 + KB * NSEG * A * 2
    return -(-b // 16) * 16


def spt_plan(K: int, S_eff: int, A: int, NSEG: int) -> Tuple[int, int, int, int]:
    """(anchor columns a scan thread AT, keypoints a block KB, threads a
    block, dynamic shared bytes) of ``csrc/spt.cu`` for K keypoints of
    S_eff points in NSEG segments and A anchor columns.  A keypoint takes
    ceil(A / AT) threads; KB keypoints fill about SPT_TARGET_THREADS
    threads, with no more keypoints than K and shared memory within
    SPT_MAX_SMEM.  The last block holds K mod KB keypoints when that is not
    0."""
    G = -(-A // SPT_ANCHORS_A_THREAD)
    if K < 1 or NSEG < 1 or S_eff % NSEG or G > SPT_MAX_THREADS:
        raise ValueError(f"spt_pooled: no plan for K={K}, S={S_eff}, A={A}, "
                         f"NSEG={NSEG}")
    KB = max(1, min(SPT_MAX_KEYPOINTS, K, SPT_TARGET_THREADS // G))
    while KB > 1 and (spt_smem_bytes(S_eff, A, NSEG, KB) > SPT_MAX_SMEM
                      or -(-KB * G // 32) * 32 > SPT_MAX_THREADS):
        KB -= 1
    smem = spt_smem_bytes(S_eff, A, NSEG, KB)
    if smem > SPT_MAX_SMEM:
        raise ValueError(f"spt_pooled: S={S_eff} needs {smem} bytes of shared "
                         "memory a keypoint")
    return SPT_ANCHORS_A_THREAD, KB, -(-KB * G // 32) * 32, smem


@functools.lru_cache(maxsize=None)
def spt_anchor_terms(rad_n: int, azi_n: int, ele_n: int, device):
    """Anchor columns in azimuth-major order (column a*G + g): the ball-test
    terms -2*ax, -2*ay, -2*az and |a|^2, each [A] (made once for each grid
    and device)."""
    G = rad_n * ele_n
    anchors = torch.as_tensor(
        gridmath.get_voxel_coordinate(1.0, rad_n, azi_n, ele_n).reshape(-1, 3),
        dtype=torch.float32, device=device)           # row g*AZ + a
    planes = anchors.reshape(G, azi_n, 3).permute(2, 1, 0).reshape(3, -1)
    ax, ay, az = planes[0], planes[1], planes[2]
    return -2.0 * ax, -2.0 * ay, -2.0 * az, ax * ax + ay * ay + az * az


def spt_weight_columns(W_all: torch.Tensor, G: int):
    """W_all [AZ, 3, 16] -> wx, wy, wz [16, A]: the azimuth row of each
    anchor column."""
    rows = torch.repeat_interleave(W_all, G, dim=0)       # [A, 3, 16]
    return tuple(rows[:, d, :].t().contiguous() for d in range(3))


def _spt_prepare(planes, R, u, rad_n, azi_n, ele_n, voxel_sample):
    """Trimmed planes, R, u, the anchor terms and the segment count."""
    NSEG, S_eff = spt_layout(planes[0].shape[1], voxel_sample)
    planes = tuple(p[:, :S_eff].float().contiguous() for p in planes)
    anchor = spt_anchor_terms(rad_n, azi_n, ele_n, u.device)
    return (planes, R.float().contiguous(), u[:S_eff].float().contiguous(),
            anchor, NSEG)


def _pooled_layout(out: torch.Tensor, rad_n, azi_n, ele_n) -> torch.Tensor:
    """[K, 16, A(=AZ*G)] -> [K, rad, ele, azi, 16]."""
    K = out.shape[0]
    G = rad_n * ele_n
    pooled = out.reshape(K, 16, azi_n, G).permute(0, 3, 2, 1)
    return pooled.reshape(K, rad_n, ele_n, azi_n, 16)


def spt_winners_plain(planes, R, u, anchor, NSEG: int, r2: float, chunk: int):
    """Per keypoint chunk: the rotated winners (x, y, z [Kc, NSEG, A]) and
    their validity; yields (k0, xs, ys, zs, valid)."""
    xP, yP, zP = planes
    K, S = xP.shape
    LS = S // NSEG
    ax2, ay2, az2, an = anchor
    neg = torch.full((), -BIG, dtype=torch.float32, device=xP.device)
    for k0 in range(0, K, chunk):
        px, py, pz = xP[k0:k0 + chunk], yP[k0:k0 + chunk], zP[k0:k0 + chunk]
        Rk = R[k0:k0 + chunk]
        rot = [px * Rk[:, 0, e, None] + py * Rk[:, 1, e, None]
               + pz * Rk[:, 2, e, None] for e in range(3)]   # [Kc, S] each
        prx, pry, prz = rot
        rhs = r2 - (prx * prx + pry * pry + prz * prz)
        t = prx[..., None] * ax2 + an
        t = t + pry[..., None] * ay2
        t = t + prz[..., None] * az2                               # [Kc, S, A]
        score = torch.where(t <= rhs[..., None], u[None, :, None], neg)
        Kc = px.shape[0]
        m, arg = score.reshape(Kc, NSEG, LS, -1).max(dim=2)          # [Kc,NSEG,A]
        pos = arg + (torch.arange(NSEG, device=xP.device) * LS)[None, :, None]
        flat = pos.reshape(Kc, -1)
        win = [torch.gather(c, 1, flat).reshape(pos.shape) for c in rot]
        yield k0, win[0], win[1], win[2], m > -BIG / 2


def spt_pooled_plain(W_all, b_eff, f0, u, planes, R, rad_n: int, azi_n: int,
                     ele_n: int, voxel_r: float, voxel_sample: int,
                     chunk: int = 128) -> torch.Tensor:
    """Fused SPT front; see :func:`spt_pooled_cuda` for the contract."""
    planes, R, u, anchor, NSEG = _spt_prepare(planes, R, u, rad_n, azi_n,
                                              ele_n, voxel_sample)
    wx, wy, wz = spt_weight_columns(W_all, rad_n * ele_n)
    K = planes[0].shape[0]
    A = wx.shape[1]
    out = torch.empty((K, 16, A), dtype=torch.float32, device=u.device)
    for k0, xs, ys, zs, ok in spt_winners_plain(
            planes, R, u, anchor, NSEG, float(voxel_r) ** 2, chunk):
        feats = (xs[:, :, None, :] * wx + ys[:, :, None, :] * wy
                 + zs[:, :, None, :] * wz + b_eff[:, None])      # [Kc,NSEG,16,A]
        feats = torch.clamp(feats, min=0.0)
        feats = torch.where(ok[:, :, None, :], feats, f0[:, None])
        out[k0:k0 + xs.shape[0]] = feats.max(dim=1).values
    return _pooled_layout(out, rad_n, azi_n, ele_n)


def spt_pooled_cuda(W_all: torch.Tensor, b_eff: torch.Tensor,
                    f0: torch.Tensor, u: torch.Tensor, planes, R: torch.Tensor,
                    rad_n: int, azi_n: int, ele_n: int, voxel_r: float,
                    voxel_sample: int) -> torch.Tensor:
    """Fused sampled-SPT + point MLP + sample max, per keypoint.

    W_all [AZ, 3, 16] derotated folded weights, b_eff and f0 [16], u [S]
    shared priorities, planes (x, y, z) [K, S] UNROTATED patch coordinates,
    R [K, 3, 3] the alignment (points rotate as p @ R).  Per anchor the
    top-priority in-ball point of each of the first voxel_sample patch
    segments is MLP'd and max-pooled; empty slots give f0.  Returns
    [K, rad_n, ele_n, azi_n, 16]."""
    cuda.check_no_grad("spt_pooled", W_all, b_eff, f0, *planes, R)
    if u.device.type == "cpu":
        return spt_pooled_plain(W_all, b_eff, f0, u, planes, R, rad_n, azi_n,
                                ele_n, voxel_r, voxel_sample)
    K, S_full = planes[0].shape
    if K == 0:
        raise ValueError("spt_pooled: no keypoints")
    NSEG, S = spt_layout(S_full, voxel_sample)
    # the kernel reads the first S of each row in place
    planes = tuple(p.float() for p in planes)
    if any(p.stride(1) != 1 or p.stride(0) != planes[0].stride(0)
           for p in planes):
        planes = tuple(p.contiguous() for p in planes)
    anchor = spt_anchor_terms(rad_n, azi_n, ele_n, u.device)
    R, u = R.float().contiguous(), u[:S].float().contiguous()
    W_all, b_eff, f0 = (t.float().contiguous() for t in (W_all, b_eff, f0))
    if W_all.data_ptr() % 16:                  # the kernel loads rows as float4
        W_all = W_all.clone()
    cuda.check_cuda("spt_pooled", *planes, R, u, *anchor, W_all, b_eff, f0)
    A = rad_n * ele_n * azi_n
    plan = spt_plan(K, S, A, NSEG)
    out = torch.empty((K, 16, A), dtype=torch.float32, device=u.device)
    SPT.launch(*(t.data_ptr() for t in (*planes, R, u, *anchor, W_all, b_eff,
                                        f0)),
               K, S, planes[0].stride(0), A, azi_n, NSEG, float(voxel_r) ** 2,
               *plan, out.data_ptr(), cuda.stream_handle(u))
    return _pooled_layout(out, rad_n, azi_n, ele_n)


def spt_valid_winners(planes, R, u, rad_n, azi_n, ele_n, voxel_r,
                      voxel_sample, chunk: int = 128) -> int:
    """Number of (keypoint, anchor, segment) slots with an in-ball winner:
    the data-dependent MLP work of the SPT front."""
    planes, R, u, anchor, NSEG = _spt_prepare(planes, R, u, rad_n, azi_n,
                                              ele_n, voxel_sample)
    return int(sum(int(ok.sum()) for *_, ok in spt_winners_plain(
        planes, R, u, anchor, NSEG, float(voxel_r) ** 2, chunk)))

