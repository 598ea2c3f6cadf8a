"""Descriptor matching and pose-hypothesis voting (counterpart of
``buffer_tpu/pipeline/matching.py``; reference models/BUFFER.py:283-311)."""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from buffer_tpu_torch.core import se3

BIG = 1e9


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim index tensor ``i``, without reading ``i`` on
    the host (indexing by a 0-dim tensor does)."""
    return torch.index_select(x, 0, i.reshape(1))[0]


class Matches(NamedTuple):
    src_idx: torch.Tensor   # [K] int32, arange
    tgt_idx: torch.Tensor   # [K] int32, NN of source keypoint i in the target
    mutual: torch.Tensor    # [K] bool


def mutual_matching(src_des, tgt_des, src_valid, tgt_valid) -> Matches:
    """Mutual nearest neighbours by max dot product of L2-normalized
    descriptors."""
    score = src_des @ tgt_des.t()
    ok = src_valid[:, None] & tgt_valid[None, :]
    score = torch.where(ok, score, torch.full_like(score, -BIG))
    s_nn = torch.argmax(score, dim=1)
    t_nn = torch.argmax(score, dim=0)
    ar = torch.arange(score.shape[0], device=score.device)
    mutual = (t_nn[s_nn] == ar) & src_valid & tgt_valid[s_nn]
    return Matches(ar.to(torch.int32), s_nn.to(torch.int32), mutual)


def pose_hypotheses(ss_kpts, tt_kpts, s_R, t_R, azi_ind, azi_n: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-match rigid hypotheses: R = t_R @ Rz(ind * 2pi/azi_n) @ s_R^T,
    t = t_kpt - R s_kpt."""
    angle = azi_ind * (2 * math.pi / azi_n) + 1e-6
    zero = torch.zeros_like(angle)
    azi_R = se3.angle_axis_to_rotation_matrix(torch.stack([zero, zero, angle], -1))
    R = t_R @ azi_R @ s_R.transpose(-1, -2)
    t = tt_kpts - (R @ ss_kpts[..., None])[..., 0]
    return R, t


def warp_sqdist(R, t, src, tgt) -> torch.Tensor:
    """``d2[h, m] = |R_h src_m + t_h - tgt_m|^2`` in the reference's
    expanded form |p|^2 + |t|^2 + |q|^2 - 2 t.q + 2 t.(R p) - 2 <R, q p^T>."""
    p2 = torch.sum(src * src, -1)
    q2 = torch.sum(tgt * tgt, -1)
    t2 = torch.sum(t * t, -1)
    tq = t @ tgt.t()
    a = torch.einsum("hi,hij->hj", t, R)
    t_Rp = a @ src.t()
    qp = (tgt[:, :, None] * src[:, None, :]).reshape(-1, 9)
    q_Rp = R.reshape(-1, 9) @ qp.t()
    d2 = (p2[None, :] + t2[:, None] + q2[None, :]
          - 2.0 * tq + 2.0 * t_Rp - 2.0 * q_Rp)
    return torch.clamp(d2, min=0.0)


def vote_hypotheses(ss_kpts, tt_kpts, R, t, mutual, azi_n: int,
                    inlier_th: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score every hypothesis against every mutual match with the
    lever-arm threshold |s_kpt| * pi/azi_n * inlier_th.  Returns (best index,
    inlier mask [M] of the winner)."""
    d2 = warp_sqdist(R, t, ss_kpts, tt_kpts)
    thr = torch.linalg.norm(ss_kpts, dim=-1) * (math.pi / azi_n) * inlier_th
    sign = (d2 < (thr * thr)[None, :]) & mutual[None, :]
    counts = torch.where(mutual, torch.sum(sign, dim=-1),
                         torch.full_like(mutual, -1, dtype=torch.int64))
    best = torch.argmax(counts)
    return best, take(sign, best)
