"""Stage-branch training forward passes (counterpart of
``buffer_tpu/pipeline/train_forward.py``).

Ports the training branches of the reference's ``buffer.forward``
(models/BUFFER.py:128-229) and the per-stage loss assembly of its trainer
(ThreeDMatch/trainer.py:134-198).  The reference's dynamic list of positive
correspondences becomes a fixed ``pos_num``-row table with a validity mask,
sampled uniformly from the in-radius nearest-neighbour pairs.

Only the active stage runs in train mode (batch statistics, running
statistics moved in place) and with gradients; frozen stages run in eval
mode without gradients, as the JAX package runs them.  Desc runs twice a
step, source then target, each call with its own batch statistics; the
patches of both clouds come from one launch of the ball-sampling kernel.
Everything runs in fp32 with TF32 off.  Random draws are inputs:
:class:`TrainDraws`.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from buffer_tpu_torch import resolve_device
from buffer_tpu_torch.config import Config
from buffer_tpu_torch.core import se3
from buffer_tpu_torch.core.numerics import safe_norm, safe_normalize
from buffer_tpu_torch.models import patch_embedder as pe
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.models.heads import equi_match
from buffer_tpu_torch.ops.neighbors import nearest, nearest_common_morton
from buffer_tpu_torch.pipeline.pyramid import build_pyramid_and_normals
from buffer_tpu_torch.pipeline.registration import (PairInputs, full_fp32,
                                                    orient_axes)
from buffer_tpu_torch.train import losses

STAGES = ("Ref", "Desc", "Keypt", "Inlier")


class MatchSample(NamedTuple):
    src_idx: torch.Tensor   # [P] int64
    tgt_idx: torch.Tensor   # [P] int64
    valid: torch.Tensor     # [P] bool


class TrainDraws(NamedTuple):
    """Every random number of one training step, uniform in [0, 1).

    match_prio [N0]: priorities of the positive-pair sampler;
    ball_prio [2, R]: ball-sampling priorities per raw cloud;
    spt_prio [2, S]: SPT priorities per cloud, shared by its patches;
    so2_angle [P]: the target's SO(2) augmentation angles over 2 pi (stage
    Inlier only)."""

    match_prio: torch.Tensor
    ball_prio: torch.Tensor
    spt_prio: torch.Tensor
    so2_angle: torch.Tensor


def make_train_draws(cfg: Config, generator: torch.Generator,
                     device=None) -> TrainDraws:
    """Draws for one step from ``generator`` (on ``device``)."""
    dev = resolve_device(device)
    rand = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    st = cfg.static
    return TrainDraws(match_prio=rand(st.points_l0),
                      ball_prio=rand(2, st.raw_points),
                      spt_prio=rand(2, cfg.patch.num_points_per_patch),
                      so2_angle=rand(cfg.train.pos_num))


def sample_matches(prio: torch.Tensor, src_pts, src_mask, tgt_pts, tgt_mask,
                   relt_pose, radius: float, num: int,
                   band: int = 0) -> MatchSample:
    """Positive pairs (models/BUFFER.py:361-380, 166-168): each source
    point's nearest target point under the ground-truth pose, kept within
    ``radius``, then the ``num`` rows of highest priority.  Rows that are
    not in radius carry priority -inf and tie; a stable descending sort
    takes them lowest index first, as ``lax.top_k`` does.  With ``band``
    restricting the target, the 1-NN runs banded on a joint Morton sort
    (:func:`nearest_common_morton`)."""
    warped = se3.transform(src_pts, relt_pose)
    if band and 2 * band < tgt_pts.shape[0]:
        d2, nn = nearest_common_morton(warped, src_mask, tgt_pts, tgt_mask,
                                       band)
    else:
        d2, nn = nearest(warped[None], tgt_pts[None], tgt_mask[None])
        d2, nn = d2[0], nn[0]
    ok = (d2 < radius * radius) & src_mask
    score = torch.where(ok, prio, torch.full_like(prio, -math.inf))
    idx = torch.sort(score, descending=True, stable=True).indices[:num]
    return MatchSample(idx, nn[idx].long(), ok[idx])


def cal_so2_gt(s_rand_axis, s_R, t_R, gt_R, azi_n: int, integer: bool,
               aug_rotation=None) -> torch.Tensor:
    """Ground-truth SO(2) azimuth label (models/BUFFER.py:81-110): the bin
    index (``integer``) or its continuous value."""
    t_rand = s_rand_axis @ gt_R.t()
    s_rand = torch.einsum("pj,pjk->pk", s_rand_axis, s_R)
    t_rand = torch.einsum("pj,pjk->pk", t_rand, t_R)
    if aug_rotation is not None:
        t_rand = torch.einsum("pj,pkj->pk", t_rand, aug_rotation)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=s_rand.dtype, device=s_rand.device)
    proj = t_rand - torch.sum(t_rand * z, dim=-1, keepdim=True) * z
    proj = safe_normalize(proj, dim=-1)
    cos = torch.sum(s_rand * proj, dim=-1) / torch.clamp(
        safe_norm(s_rand, dim=-1) * safe_norm(proj, dim=-1), min=1e-8)
    ang = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    neg = torch.sum(torch.cross(s_rand, proj, dim=-1) * z, dim=-1) < 0
    ang = torch.where(neg, 2 * math.pi - ang, ang)
    lab = ang * azi_n / (2 * math.pi)
    if integer:
        return torch.round(lab).to(torch.int64) % azi_n
    return torch.where(lab >= azi_n, torch.zeros_like(lab), lab).detach()


def _describe(model: BufferModel, cfg: Config, patches, axes, spt_prio,
              so2_angle=None):
    """The training-path MiniSpinNet call on one cloud's patches
    (models/BUFFER.py:178-183): align, scale by des_r, optional SO(2)
    augmentation, sampled SPT, network."""
    p = cfg.patch
    delta, rand_axis, R = pe.axis_align(patches, cfg.data.dataset, axes)
    delta = delta / p.des_r
    if so2_angle is not None:
        delta, rand_axis, aug = pe.so2_augment(so2_angle, delta, rand_axis)
    else:
        aug = torch.eye(3, dtype=delta.dtype,
                        device=delta.device).expand(delta.shape[0], 3, 3)
    inv = pe.spt(spt_prio, delta, p.rad_n, p.azi_n, p.ele_n,
                 p.delta / p.rad_n, p.voxel_sample)
    desc, equi = model.Desc(inv_patches=inv)
    return dict(desc=desc, equi=equi, rand_axis=rand_axis, R=R, aug=aug)


def stage_loss(model: BufferModel, stage: str, inputs: PairInputs,
               relt_pose: torch.Tensor, draws: TrainDraws, train: bool = True,
               det_margin: float = 1.05, device=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and stats of ``stage`` on one pair with ground-truth pose
    relt_pose [4, 4], on ``device`` (default: the CUDA card; the model must
    live there).  Puts every stage in eval mode, and with ``train`` the
    active one in train mode: it moves its running statistics and the loss
    carries gradients to its parameters only."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}")
    dev = resolve_device(device)
    if next(model.parameters()).device != dev:
        raise ValueError(f"model lives on {next(model.parameters()).device}, "
                         f"not on {dev}")
    move = lambda t: None if t is None else t.to(dev)
    inputs = PairInputs(*(move(t) for t in inputs))
    draws = TrainDraws(*(move(t) for t in draws))
    model.eval()
    getattr(model, stage).train(train)
    with full_fp32():
        return _stage_loss(model, stage, inputs, move(relt_pose), draws,
                           train, det_margin)


def _stage_loss(model, stage, inputs, relt_pose, draws, train, det_margin):
    cfg = model.cfg
    grad = lambda s: torch.set_grad_enabled(train and stage == s)
    gt_R = relt_pose[:3, :3]

    with torch.no_grad():
        levels = (None if inputs.lvl1 is None else
                  (inputs.lvl1, inputs.lvl1_mask, inputs.lvl2, inputs.lvl2_mask))
        pyr = build_pyramid_and_normals(cfg, inputs.sds, inputs.sds_mask, levels)
    with grad("Ref"):
        axis, eps, branch = model.Ref(pyr)
        axis = orient_axes(axis, inputs.sds)

    with torch.no_grad():
        m = sample_matches(draws.match_prio, inputs.sds[0], inputs.sds_mask[0],
                           inputs.sds[1], inputs.sds_mask[1], relt_pose,
                           cfg.data.voxel_size_0, cfg.train.pos_num,
                           band=cfg.static.knn_band)
    src_axis, tgt_axis = axis[0][m.src_idx], axis[1][m.tgt_idx]
    src_kpt, tgt_kpt = inputs.sds[0][m.src_idx], inputs.sds[1][m.tgt_idx]

    if stage == "Ref":
        with grad("Ref"):
            loss, err = losses.ref_loss(src_axis, tgt_axis, gt_R,
                                        eps[0][m.src_idx], eps[1][m.tgt_idx],
                                        m.valid)
        return loss, {"ref_loss": loss, "ref_error": err}

    p = cfg.patch
    with torch.no_grad():
        patches = pe.extract_patches(inputs.raw, inputs.raw_mask,
                                     draws.ball_prio,
                                     torch.stack([src_kpt, tgt_kpt]),
                                     p.des_r, p.num_points_per_patch)
    with grad("Desc"):
        src = _describe(model, cfg, patches[0], src_axis,
                        draws.spt_prio[0])
        tgt = _describe(model, cfg, patches[1], tgt_axis,
                        draws.spt_prio[1],
                        draws.so2_angle if stage == "Inlier" else None)

    if stage == "Desc":
        with grad("Desc"):
            dl, _, acc = losses.contrastive_loss(
                src["desc"], tgt["desc"], losses.cdist(tgt_kpt, tgt_kpt),
                m.valid)
            score = equi_match(src["equi"], tgt["equi"], p.azi_n)
            lab = cal_so2_gt(src["rand_axis"], src["R"], tgt["R"], gt_R,
                             p.azi_n, integer=True)
            el, eacc = losses.eqv_ce_loss(score, lab, m.valid)
            loss = 4.0 * dl + el        # RoReg weighting (trainer.py:165)
        return loss, {"desc_loss": dl, "desc_acc": acc, "eqv_loss": el,
                      "eqv_acc": eacc}

    if stage == "Keypt":
        branch = {"bottle": branch["bottle"].detach(),
                  "skips": tuple(s.detach() for s in branch["skips"])}
        with grad("Keypt"):
            det = model.Keypt(pyr, branch)
            _, ratio, acc = losses.contrastive_loss(
                src["desc"], tgt["desc"], losses.cdist(src_kpt, src_kpt),
                m.valid)
            loss = losses.det_loss(det[0][m.src_idx], det[1][m.tgt_idx], ratio,
                                   m.valid, det_margin)
        return loss, {"det_loss": loss, "desc_acc": acc}

    band = slice(1, p.ele_n - 1)
    with grad("Inlier"):
        pred = model.Inlier(src["equi"][:, band], tgt["equi"][:, band])
        lab = cal_so2_gt(src["rand_axis"], src["R"], tgt["R"], gt_R, p.azi_n,
                         integer=False, aug_rotation=tgt["aug"])
        loss = losses.l1_loss(pred, lab, m.valid)
    return loss, {"match_loss": loss}
