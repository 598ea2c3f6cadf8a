"""Training losses (counterpart of ``buffer_tpu/train/losses.py``).

Masked static-shape ports of the reference losses: batch-hard contrastive
with safe-radius masking (loss/desc_loss.py:60-109), the probabilistic
cosine loss of the Ref stage (ThreeDMatch/trainer.py:134-147), the detector
loss ``mean((margin - diff) * sigma)`` (trainer.py:173-187), cross entropy
on the EquiMatch logits and L1 on the azimuth index (trainer.py:153-198).
Each takes a validity mask of the padded correspondence rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from buffer_tpu_torch.core.numerics import safe_norm

BIG = 1e5


def cdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix with the reference's sqrt fudge
    (loss/desc_loss.py:25-57)."""
    diff = a[:, None, :] - b[None, :, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)


def contrastive_loss(anchor: torch.Tensor, positive: torch.Tensor,
                     dist_keypts: torch.Tensor, valid: torch.Tensor,
                     pos_margin: float = 0.1, neg_margin: float = 1.4,
                     safe_radius: float = 0.10
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch-hard contrastive loss of anchor [P, C] against positive [P, C]
    (row i matches row i); dist_keypts [P, P] masks negatives closer than
    the safe radius.  Returns (loss, ratio = closest negative / (furthest
    positive + 1e-6), accuracy in %)."""
    P = anchor.shape[0]
    dist = cdist(anchor, positive)
    eye = torch.eye(P, dtype=torch.bool, device=anchor.device)
    near = (dist_keypts + 10.0 * eye) < safe_radius
    dist = dist + 10.0 * near
    pair_valid = valid[:, None] & valid[None, :]
    furthest_positive = torch.diagonal(dist)
    closest_negative = torch.amin(torch.where(
        pair_valid & ~eye, dist, torch.full_like(dist, BIG)), dim=1)
    diff = furthest_positive - closest_negative
    vf = valid.to(anchor.dtype)
    nv = torch.clamp(torch.sum(vf), min=1.0)
    accuracy = torch.sum((diff < 0) & valid) * 100.0 / nv
    loss = (torch.clamp(furthest_positive - pos_margin, min=0.0)
            + torch.clamp(neg_margin - closest_negative, min=0.0))
    loss = torch.sum(loss * vf) / nv
    ratio = closest_negative / (furthest_positive + 1e-6)
    return loss, ratio, accuracy


def ref_loss(src_axis, tgt_axis, gt_R, src_s, tgt_s, valid):
    """err = 1 - |cos(src_axis @ R^T, tgt_axis)|, loss = mean(log e + err/e)
    with e the mean of both clouds' eps.  Returns (loss, mean err)."""
    rot = src_axis @ gt_R.t()
    cos = torch.sum(rot * tgt_axis, dim=-1) / torch.clamp(
        safe_norm(rot, dim=-1) * safe_norm(tgt_axis, dim=-1), min=1e-8)
    err = 1.0 - torch.abs(cos)
    eps = (src_s[:, 0] + tgt_s[:, 0]) / 2.0
    per = torch.log(eps) + err / eps
    vf = valid.to(per.dtype)
    nv = torch.clamp(torch.sum(vf), min=1.0)
    return torch.sum(per * vf) / nv, torch.sum(err * vf) / nv


def det_loss(src_s, tgt_s, diff_ratio, valid, margin: float = 1.05):
    """Detector saliency loss; no gradient through the descriptor ratio."""
    sigma = (src_s[:, 0] + tgt_s[:, 0]) / 2.0
    per = (margin - diff_ratio.detach()) * sigma
    vf = valid.to(per.dtype)
    return torch.sum(per * vf) / torch.clamp(torch.sum(vf), min=1.0)


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    m = torch.amax(x, dim=-1, keepdim=True)
    return m + torch.log(torch.sum(torch.exp(x - m), dim=-1, keepdim=True))


def eqv_ce_loss(logits, labels, valid):
    """Cross entropy over the azimuth bins and accuracy (a fraction)."""
    logp = logits - _logsumexp(logits)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    vf = valid.to(nll.dtype)
    nv = torch.clamp(torch.sum(vf), min=1.0)
    acc = torch.sum((torch.argmax(logits, dim=1) == labels) & valid) / nv
    return torch.sum(nll * vf) / nv, acc


def l1_loss(pred, target, valid):
    """Azimuth-index L1."""
    vf = valid.to(pred.dtype)
    return torch.sum(torch.abs(pred - target) * vf) / torch.clamp(
        torch.sum(vf), min=1.0)
