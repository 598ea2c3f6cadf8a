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

from typing import Tuple

import torch

from buffer_tpu_torch.core import gridmath
from buffer_tpu_torch.kernels import cuda
from buffer_tpu_torch.kernels.cuda import F, I, P

BIG = 1e9

NEAREST = cuda.register(cuda.Kernel(
    "nearest", "buffer_tpu_torch/csrc/nearest.cu", "nearest_launch",
    [P, P, P, I, I, I, P, P, P],
    "buffer_tpu/kernels/geom_pallas.py:269"))
BALL = cuda.register(cuda.Kernel(
    "ball_sample", "buffer_tpu_torch/csrc/ball.cu", "ball_launch",
    [P, P, P, P, P, P, I, I, I, I, F, P, P, P, P, P],
    "buffer_tpu/kernels/geom_pallas.py:182"))
BALL_POINTS = cuda.register(cuda.Kernel(
    "ball_sample_points", "buffer_tpu_torch/csrc/ball.cu", "ball_points_launch",
    [P, P, P, P, P, P, I, I, I, I, F, P, P, P],
    "buffer_tpu/kernels/geom_pallas.py:115"))
SPT = cuda.register(cuda.Kernel(
    "spt_pooled", "buffer_tpu_torch/csrc/spt.cu", "spt_launch",
    [P] * 14 + [I, I, I, I, F, P, P],
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


def nearest_cuda(query: torch.Tensor, support: torch.Tensor,
                 valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN of :func:`nearest_plain`, batched over clouds."""
    cuda.check_no_grad("nearest", query, support)
    if query.device.type == "cpu":
        return nearest_plain(query, support, valid)
    query = query.contiguous().float()
    support = support.contiguous().float()
    valid_u8 = valid.to(torch.uint8).contiguous()
    cuda.check_cuda("nearest", query, support, valid_u8)
    B, Q, _ = query.shape
    S = support.shape[1]
    if Q == 0 or S == 0 or support.shape[0] != B or valid.shape != (B, S):
        raise ValueError(f"nearest: bad shapes {query.shape}, "
                         f"{support.shape}, {valid.shape}")
    d = torch.empty((B, Q), dtype=torch.float32, device=query.device)
    i = torch.empty((B, Q), dtype=torch.int32, device=query.device)
    NEAREST.launch(query.data_ptr(), support.data_ptr(), valid_u8.data_ptr(),
                   B, Q, S, d.data_ptr(), i.data_ptr(),
                   cuda.stream_handle(query))
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
    r2 = torch.tensor(float(radius) ** 2, dtype=torch.float32,
                      device=query.device)
    u = torch.where(support_valid, prio, torch.full_like(prio, -BIG))
    gx, gy, gz, gn, gu = _ball_grids(support, u, NS)
    outs = [torch.empty((B, Q, k), dtype=torch.float32, device=query.device)
            for _ in range(3)]
    vout = torch.empty((B, Q, k), dtype=torch.bool, device=query.device)
    neg = torch.tensor(-BIG, dtype=torch.float32, device=query.device)
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


def _ball_kernel_inputs(name: str, query, support, support_valid, prio, k: int):
    """Contiguous f32 queries and the five [B, L, NS] support grids."""
    query = query.contiguous().float()
    u = torch.where(support_valid, prio, torch.full_like(prio, -BIG))
    grids = _ball_grids(support.float(), u.float(), k // 2)
    cuda.check_cuda(name, query, *grids)
    return query, grids


def ball_sample_planes_cuda(query, support, support_valid, prio,
                            radius: float, k: int):
    """Ball sampling of :func:`ball_sample_planes_plain`, batched over
    clouds (reference: pointnet2 ball_query over a shuffled cloud)."""
    _check_ball("ball_sample", query, support, k)
    if query.device.type == "cpu":
        return ball_sample_planes_plain(query, support, support_valid, prio,
                                        radius, k)
    query, grids = _ball_kernel_inputs("ball_sample", query, support,
                                       support_valid, prio, k)
    B, Q, _ = query.shape
    x, y, z = (torch.empty((B, Q, k), dtype=torch.float32, device=query.device)
               for _ in range(3))
    v = torch.empty((B, Q, k), dtype=torch.uint8, device=query.device)
    BALL.launch(query.data_ptr(), *(g.data_ptr() for g in grids), B, Q,
                support.shape[1] // (k // 2), k // 2, float(radius) ** 2,
                x.data_ptr(), y.data_ptr(), z.data_ptr(), v.data_ptr(),
                cuda.stream_handle(query))
    return x, y, z, v.bool()


def ball_sample_points_cuda(query, support, support_valid, prio,
                            radius: float, k: int):
    """Ball sampling of :func:`ball_sample_points_plain` in one launch over
    all clouds: query [B, Q, 3], support [B, N, 3], support_valid and the
    priorities prio [B, N] -> (points [B, Q, k, 3], valid [B, Q, k]); k even,
    k/2 <= 1024 dividing N.  The points are copies of support points (no
    backward; see the module docstring)."""
    _check_ball("ball_sample_points", query, support, k)
    if query.device.type == "cpu":
        return ball_sample_points_plain(query, support, support_valid, prio,
                                        radius, k)
    query, grids = _ball_kernel_inputs("ball_sample_points", query, support,
                                       support_valid, prio, k)
    B, Q, _ = query.shape
    pts = torch.empty((B, Q, k, 3), dtype=torch.float32, device=query.device)
    v = torch.empty((B, Q, k), dtype=torch.uint8, device=query.device)
    BALL_POINTS.launch(query.data_ptr(), *(g.data_ptr() for g in grids), B, Q,
                       support.shape[1] // (k // 2), k // 2,
                       float(radius) ** 2, pts.data_ptr(), v.data_ptr(),
                       cuda.stream_handle(query))
    return pts, v.bool()


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


def spt_anchor_terms(rad_n: int, azi_n: int, ele_n: int, device):
    """Anchor columns in azimuth-major order (column a*G + g): the ball-test
    terms -2*ax, -2*ay, -2*az and |a|^2, each [A]."""
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
    neg = torch.tensor(-BIG, dtype=torch.float32, device=xP.device)
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
    planes, R, u, anchor, NSEG = _spt_prepare(planes, R, u, rad_n, azi_n,
                                              ele_n, voxel_sample)
    w = spt_weight_columns(W_all.float(), rad_n * ele_n)
    b_eff = b_eff.contiguous().float()
    f0 = f0.contiguous().float()
    cuda.check_cuda("spt_pooled", *planes, R, u, *anchor, *w, b_eff, f0)
    K, S = planes[0].shape
    A = w[0].shape[1]
    if K == 0:
        raise ValueError("spt_pooled: no keypoints")
    out = torch.empty((K, 16, A), dtype=torch.float32, device=u.device)
    SPT.launch(*(t.data_ptr() for t in (*planes, R, u, *anchor, *w, b_eff, f0)),
               K, S, A, NSEG, float(voxel_r) ** 2, out.data_ptr(),
               cuda.stream_handle(u))
    return _pooled_layout(out, rad_n, azi_n, ele_n)


def spt_valid_winners(planes, R, u, rad_n, azi_n, ele_n, voxel_r,
                      voxel_sample, chunk: int = 128) -> int:
    """Number of (keypoint, anchor, segment) slots with an in-ball winner:
    the data-dependent MLP work of the SPT front."""
    planes, R, u, anchor, NSEG = _spt_prepare(planes, R, u, rad_n, azi_n,
                                              ele_n, voxel_sample)
    return int(sum(int(ok.sum()) for *_, ok in spt_winners_plain(
        planes, R, u, anchor, NSEG, float(voxel_r) ** 2, chunk)))

