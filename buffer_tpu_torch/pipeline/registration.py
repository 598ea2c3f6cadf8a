"""End-to-end registration of one fragment pair (counterpart of
``buffer_tpu/pipeline/registration.py``; reference models/BUFFER.py:231-333).

Stages: input normals and the conv pyramid, EFCNN axes and DetNet
saliency, the detector threshold and FPS keypoints, MiniSpinNet
descriptors of both clouds in one batch, mutual matching, the SO(2) cost
volume, hypothesis voting, batched RANSAC and IRLS refinement.  Four stages
run through the CUDA kernels of ``kernels/``: the pyramid's neighbour
tables (banded radius-kNN, banded and exact 1-NN), FPS, patch ball
sampling and the fused SPT front (with ``static.fused_desc`` off, the
reference's sampled front instead: stacked-point ball sampling, then the
sampled SPT in PyTorch).

Everything runs in fp32 at full precision (TF32 off for matmuls and cuDNN
convolutions), as the reference runs at ``default_matmul_precision
("highest")``.  Randomness is an input: :class:`Draws`.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from buffer_tpu_torch import resolve_device
from buffer_tpu_torch.config import Config
from buffer_tpu_torch.models import patch_embedder as pe
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.ops.sampling import farthest_point_sample_batched
from buffer_tpu_torch.pipeline import matching, ransac, refine
from buffer_tpu_torch.pipeline.pyramid import build_pyramid_and_normals


class PairInputs(NamedTuple):
    """Static-shape inputs of one fragment pair (both clouds padded to the
    ``cfg.static`` plan).  ``raw`` is the first-downsample cloud the
    patches are sampled from, ``sds`` the second-downsample cloud the point
    learner runs on, ``lvl1``/``lvl2`` the host-built pyramid levels (None:
    the pyramid builds them on the device)."""

    raw: torch.Tensor         # [2, R, 3]
    raw_mask: torch.Tensor    # [2, R]
    sds: torch.Tensor         # [2, S0, 3]
    sds_mask: torch.Tensor    # [2, S0]
    lvl1: Optional[torch.Tensor] = None       # [2, S1, 3]
    lvl1_mask: Optional[torch.Tensor] = None
    lvl2: Optional[torch.Tensor] = None       # [2, S2, 3]
    lvl2_mask: Optional[torch.Tensor] = None


class Draws(NamedTuple):
    """Every random number register_pair uses.

    ball_prio [2, R]: uniform ball-sampling priorities per raw cloud;
    spt_prio [S]: uniform SPT priorities shared by all patches;
    ransac_gumbel [H, 3, K]: Gumbel noise of the RANSAC draws;
    ransac_gumbel_boost [4H, 3, K]: the same for the low-match budget
    (None when ``static.low_match_boost`` is off)."""

    ball_prio: torch.Tensor
    spt_prio: torch.Tensor
    ransac_gumbel: torch.Tensor
    ransac_gumbel_boost: Optional[torch.Tensor] = None


class RegistrationResult(NamedTuple):
    pose: torch.Tensor         # [4, 4] src -> tgt
    num_mutual: torch.Tensor   # [] int64
    num_inliers: torch.Tensor  # [] int64
    kpts: torch.Tensor         # [2, K, 3]
    kpt_valid: torch.Tensor    # [2, K]


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms in (0, 1)."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def make_draws(cfg: Config, generator: torch.Generator, device=None) -> Draws:
    """Draws for one registration from ``generator`` (on ``device``)."""
    dev = resolve_device(device)
    rand = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    H, K = cfg.match.hypotheses, cfg.point.num_keypts
    boost = (gumbel_from_uniform(rand(4 * H, 3, K))
             if cfg.static.low_match_boost else None)
    return Draws(ball_prio=rand(2, cfg.static.raw_points),
                 spt_prio=rand(cfg.patch.num_points_per_patch),
                 ransac_gumbel=gumbel_from_uniform(rand(H, 3, K)),
                 ransac_gumbel_boost=boost)


def orient_axes(axis: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Normalize and flip toward the origin-facing hemisphere
    (models/BUFFER.py:244-249)."""
    nrm = torch.sqrt(torch.clamp(torch.sum(axis * axis, dim=-1), min=1e-24))
    s = torch.where(torch.sum(axis * pts, dim=-1) > 0, -1.0, 1.0) / nrm
    return axis * s[..., None]


def describe_both(model: BufferModel, cfg: Config, draws: Draws, raw, raw_mask,
                  kpts, axes):
    """MiniSpinNet over both clouds' keypoints in one batch [2K, ...].

    With ``cfg.static.fused_desc`` the fused front: patches as coordinate
    planes, then the SPT, point MLP and sample max in one kernel.
    Otherwise the reference's sampled front
    (``buffer_tpu/pipeline/registration.py:124-164``): stacked patches,
    centred, scaled by des_r and rotated as ``delta @ R``, the sampled
    :func:`~buffer_tpu_torch.models.patch_embedder.spt`, then the network
    on the sampled patches."""
    p = cfg.patch
    K = kpts.shape[1]
    R_all = pe.align_rotation(cfg.data.dataset, axes.reshape(2 * K, 3))
    if cfg.static.fused_desc:
        x, y, z = pe.extract_patch_planes(raw, raw_mask, draws.ball_prio, kpts,
                                          p.des_r, p.num_points_per_patch)
        planes = tuple(((c - kpts[..., d:d + 1]) / p.des_r).reshape(2 * K, -1)
                       for d, c in enumerate((x, y, z)))
        pooled = pe.fused_point_features(
            model.Desc, draws.spt_prio, planes, R_all, p.rad_n, p.azi_n,
            p.ele_n, p.delta / p.rad_n, p.voxel_sample)
        desc, equi = model.Desc(pooled)
    else:
        patches = pe.extract_patches(raw, raw_mask, draws.ball_prio, kpts,
                                     p.des_r, p.num_points_per_patch)
        delta = (patches - patches[:, :, -1:]) / p.des_r
        delta = delta.reshape(2 * K, -1, 3) @ R_all
        inv = pe.spt(draws.spt_prio, delta, p.rad_n, p.azi_n, p.ele_n,
                     p.delta / p.rad_n, p.voxel_sample)
        desc, equi = model.Desc(inv_patches=inv)
    Rs = R_all.reshape(2, K, 3, 3)
    return (desc[:K], equi[:K], Rs[0]), (desc[K:], equi[K:], Rs[1])


@contextlib.contextmanager
def full_fp32():
    """TF32 off for matmuls and cuDNN convolutions within the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


class StageTimer:
    """CUDA events recorded between the stages of :func:`register_pair`."""

    STAGES = ("pyramid", "ref_keypt", "fps", "descriptors", "tail")

    def __init__(self):
        self.events = []

    def mark(self) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)

    def stage_ms(self) -> dict:
        """Milliseconds per stage (synchronizes on the last event)."""
        self.events[-1].synchronize()
        return {name: a.elapsed_time(b) for name, a, b in
                zip(self.STAGES, self.events, self.events[1:])}


def register_pair(model: BufferModel, inputs: PairInputs, draws: Draws,
                  device=None, return_intermediates: bool = False,
                  timer: Optional[StageTimer] = None):
    """Registers one pair on ``device`` (default: the CUDA card).  The model
    must already live there.  Returns a :class:`RegistrationResult`, and
    with ``return_intermediates`` also the per-stage dict of the
    reference's ``register_pair``.  A ``timer`` (CUDA only) records an
    event at each stage boundary."""
    dev = resolve_device(device)
    if next(model.parameters()).device != dev:
        raise ValueError(f"model lives on {next(model.parameters()).device}, "
                         f"not on {dev}")
    if model.training:
        raise ValueError("register_pair runs the model in eval mode only")
    move = lambda t: None if t is None else t.to(dev)
    inputs = PairInputs(*(move(t) for t in inputs))
    draws = Draws(*(move(t) for t in draws))
    with torch.no_grad(), full_fp32():
        return _register_pair(model, inputs, draws, return_intermediates,
                              timer.mark if timer is not None else lambda: None)


def _register_pair(model: BufferModel, inputs: PairInputs, draws: Draws,
                   return_intermediates: bool, mark):
    cfg = model.cfg
    K = cfg.point.num_keypts
    mark()

    # 1+2. input normals + conv pyramid, EFCNN axes, DetNet saliency
    levels = (None if inputs.lvl1 is None else
              (inputs.lvl1, inputs.lvl1_mask, inputs.lvl2, inputs.lvl2_mask))
    pyr = build_pyramid_and_normals(cfg, inputs.sds, inputs.sds_mask, levels)
    mark()
    axis, eps, branch = model.Ref(pyr)
    axis = orient_axes(axis, inputs.sds)
    score = model.Keypt(pyr, branch)[..., 0]
    mark()

    # 3. detector threshold + FPS keypoints (models/BUFFER.py:255-271)
    eligible = inputs.sds_mask & (score > cfg.point.keypts_th)
    kidx, kvalid = farthest_point_sample_batched(inputs.sds, eligible, K)
    gather = lambda a: torch.gather(a, 1, kidx.long()[..., None].expand(-1, -1, 3))
    kpts, kaxes = gather(inputs.sds), gather(axis)
    mark()

    # 4. descriptors of both clouds
    (s_des, s_equi, s_R), (t_des, t_equi, t_R) = describe_both(
        model, cfg, draws, inputs.raw, inputs.raw_mask, kpts, kaxes)
    mark()

    # 5. mutual matching (models/BUFFER.py:283-289)
    m = matching.mutual_matching(s_des, t_des, kvalid[0], kvalid[1])
    tgt = m.tgt_idx.long()
    ss_kpts, tt_kpts = kpts[0], kpts[1][tgt]
    ss_R, tt_R = s_R, t_R[tgt]

    # 6. SO(2) azimuth from the cost volume on the reduced elevation band
    band = slice(1, cfg.patch.ele_n - 1)
    ind = model.Inlier(s_equi[:, band], t_equi[:, band][tgt])

    # 7. per-match hypotheses + voting (models/BUFFER.py:294-311)
    R_h, t_h = matching.pose_hypotheses(ss_kpts, tt_kpts, ss_R, tt_R, ind,
                                        cfg.patch.azi_n)
    best, vote_inliers = matching.vote_hypotheses(
        ss_kpts, tt_kpts, R_h, t_h, m.mutual, cfg.patch.azi_n,
        cfg.match.inlier_th)

    # 8+9. RANSAC on the winner's inliers, then IRLS; a starved match set
    # (a host-side branch on the mutual count) gets 4x hypotheses and 2x
    # IRLS rounds (the reference's adaptive budget, models/BUFFER.py:318-324)
    num_mutual = torch.sum(m.mutual)
    gumbel, iters = draws.ransac_gumbel, cfg.static.refine_iters
    if cfg.static.low_match_boost and int(num_mutual) < cfg.static.low_match_th:
        gumbel, iters = draws.ransac_gumbel_boost, 2 * iters
    pose, ransac_inl = ransac.ransac_pose(gumbel, ss_kpts, tt_kpts, vote_inliers,
                                          cfg.match.dist_th, cfg.match.similar_th)
    if cfg.test.pose_refine:
        th = 1.2 if cfg.data.dataset == "KITTI" else 0.10
        pose = refine.post_refinement(pose, ss_kpts, tt_kpts, m.mutual, th,
                                      iters=iters)

    mark()
    result = RegistrationResult(pose=pose, num_mutual=num_mutual,
                                num_inliers=torch.sum(ransac_inl),
                                kpts=kpts, kpt_valid=kvalid)
    if not return_intermediates:
        return result
    return result, {
        "pyramid": pyr, "axis": axis, "eps": eps, "score": score,
        "kidx": kidx, "kvalid": kvalid, "kpts": kpts, "kaxes": kaxes,
        "s_des": s_des, "t_des": t_des, "s_equi": s_equi, "t_equi": t_equi,
        "s_R": s_R, "t_R": t_R, "matches": m, "azi_ind": ind,
        "best_hyp": best, "vote_inliers": vote_inliers, "R_h": R_h,
        "t_h": t_h,
    }
