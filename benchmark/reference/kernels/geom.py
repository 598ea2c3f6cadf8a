# Frozen copy of buffer_tpu_torch/kernels/geom_cuda.py at commit c88a0e7761321c01585f758b60ff2700171e6a6a: the
# plain versions of the port's kernels, which define what each kernel
# computes (launchers and plans left out).  The benchmark's reference calls
# them for the kernels' semantics only.  Do not edit.
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

from benchmark.reference.kernels import gridmath

BIG = 1e9


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
    """Fused SPT front; see :func:`spt_pooled_plain` for the contract."""
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


