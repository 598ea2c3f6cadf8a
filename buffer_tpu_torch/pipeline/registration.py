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

:func:`register_pair` runs a pair operator by operator;
:func:`make_unrolled_register_fn` runs the same two parts,
:func:`pair_front` and :func:`pair_tail`, of U pairs as captured CUDA
graphs side by side on streams of their own, as the JAX package compiles
U ``register_pair`` traces into one program; :func:`make_register_fn` is
that program at U = 1, as the JAX package runs ``register_pair`` as one
jitted program.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch

from buffer_tpu_torch import resolve_device
from buffer_tpu_torch.config import Config
from buffer_tpu_torch.core import graphs
from buffer_tpu_torch.core.numerics import full_fp32
from buffer_tpu_torch.kernels import cuda
from buffer_tpu_torch.models import patch_embedder as pe
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.ops.sampling import farthest_point_sample_batched
from buffer_tpu_torch.pipeline import matching, ransac, refine
from buffer_tpu_torch.pipeline.pyramid import build_pyramid_and_normals
from buffer_tpu_torch.utils import profiling


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


def describe_cloud(model: BufferModel, cfg: Config, prio: torch.Tensor,
                   spt_prio: torch.Tensor, raw: torch.Tensor,
                   raw_mask: torch.Tensor, kpts: torch.Tensor,
                   axes: Optional[torch.Tensor] = None):
    """MiniSpinNet over one cloud's keypoints, as the JAX package's
    ``describe_cloud`` (``buffer_tpu/pipeline/registration.py:75-115``):
    patches (``ball_sample_points``, ball priorities prio [R]), aligned by
    :func:`~buffer_tpu_torch.models.patch_embedder.axis_align` with the
    rotation applied (axes [K, 3], or None: each patch's own
    ``cal_z_axis``), scaled by 1 / des_r, then the fused front with an
    identity alignment or, with ``fused_desc`` off, the sampled SPT (SPT
    priorities spt_prio [S]).  raw [R, 3], raw_mask [R], kpts [K, 3] ->
    (desc [K, 32], equi [K, ele, azi, 32], R [K, 3, 3]).  Inference: no
    gradients, TF32 off."""
    p = cfg.patch
    with torch.no_grad(), full_fp32():
        patches = pe.extract_patches(raw[None], raw_mask[None], prio[None],
                                     kpts[None], p.des_r,
                                     p.num_points_per_patch)[0]
        delta, _, R = pe.axis_align(patches, cfg.data.dataset, axes)
        delta = delta / p.des_r
        if cfg.static.fused_desc:
            eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
            pooled = pe.fused_point_features(
                model.Desc, spt_prio, tuple(delta.unbind(-1)),
                eye.expand(delta.shape[0], 3, 3), p.rad_n, p.azi_n, p.ele_n,
                p.delta / p.rad_n, p.voxel_sample)
            desc, equi = model.Desc(pooled)
        else:
            inv = pe.spt(spt_prio, delta, p.rad_n, p.azi_n, p.ele_n,
                         p.delta / p.rad_n, p.voxel_sample)
            desc, equi = model.Desc(inv_patches=inv)
    return desc, equi, R


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


class StageTimer:
    """Timing events at the stage boundaries that :func:`pair_front` (six
    marks: its start, the ends of its five stages) and :func:`pair_tail`
    (three: its start, between RANSAC and IRLS, its end) mark.  The events
    are external, so inside a stream capture each mark becomes an
    event-record node of the graph, which every replay records again: the
    same timer serves the eager :func:`register_pair` and a captured
    front or tail."""

    STAGES = ("pyramid", "ref_keypt", "fps", "descriptors", "match",
              "ransac", "refine")
    FRONT, TAIL = STAGES[:5], STAGES[5:]

    def __init__(self):
        self.events = []

    def mark(self) -> None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        self.events.append(ev)

    def ready(self) -> bool:
        """Whether the last mark's work is done (never waits)."""
        return self.events[-1].query()

    def stage_ms(self, wait: bool = True) -> dict:
        """Milliseconds of each stage the marks bound: a front's six marks
        give :attr:`FRONT`, a tail's three :attr:`TAIL`, a pair's nine
        both.  With ``wait`` it first waits for the last mark."""
        if wait:
            self.events[-1].synchronize()
        ev = self.events
        runs = {6: ((self.FRONT, ev),), 3: ((self.TAIL, ev),),
                9: ((self.FRONT, ev[:6]), (self.TAIL, ev[6:]))}[len(ev)]
        return {name: a.elapsed_time(b) for names, e in runs
                for name, a, b in zip(names, e, e[1:])}


def _check_model(model: BufferModel, dev: torch.device) -> None:
    if next(model.parameters()).device != dev:
        raise ValueError(f"model lives on {next(model.parameters()).device}, "
                         f"not on {dev}")
    if model.training:
        raise ValueError("register_pair runs the model in eval mode only")


def register_pair(model: BufferModel, inputs: PairInputs, draws: Draws,
                  device=None, return_intermediates: bool = False,
                  timer: Optional[StageTimer] = None):
    """Registers one pair on ``device`` (default: the CUDA card).  The model
    must already live there.  Returns a :class:`RegistrationResult`, and
    with ``return_intermediates`` also the per-stage dict of the
    reference's ``register_pair``.  A :class:`StageTimer` (CUDA only)
    records an event at each stage boundary.  Runs operator by operator;
    :func:`make_register_fn` runs the same front and tail as CUDA graphs."""
    dev = resolve_device(device)
    _check_model(model, dev)
    move = lambda t: None if t is None else t.to(dev)
    inputs = PairInputs(*(move(t) for t in inputs))
    draws = Draws(*(move(t) for t in draws))
    mark = timer.mark if timer is not None else lambda: None
    with torch.no_grad(), full_fp32():
        front, inter = pair_front(model, inputs, draws, mark)
        boost = boost_taken(model.cfg, front.num_mutual)
        pose, num_inliers = pair_tail(model.cfg, front,
                                      *tail_budget(model.cfg, draws, boost),
                                      mark)
    result = RegistrationResult(pose=pose, num_mutual=front.num_mutual,
                                num_inliers=num_inliers, kpts=front.kpts,
                                kpt_valid=front.kpt_valid)
    return (result, inter) if return_intermediates else result


class Front(NamedTuple):
    """What :func:`pair_front` hands the tail, and the pair's outputs that
    it computes."""

    ss_kpts: torch.Tensor       # [K, 3] source keypoints
    tt_kpts: torch.Tensor       # [K, 3] their nearest target keypoints
    mutual: torch.Tensor        # [K] bool
    vote_inliers: torch.Tensor  # [K] bool: the winning hypothesis's inliers
    num_mutual: torch.Tensor    # [] int64
    kpts: torch.Tensor          # [2, K, 3]
    kpt_valid: torch.Tensor     # [2, K]


def reference_axes(model: BufferModel, pyr, sds: torch.Tensor):
    """EFCNN on the pyramid: (axes oriented toward the origin-facing
    hemisphere, eps, the branch DetNet reads)."""
    axis, eps, branch = model.Ref(pyr)
    return orient_axes(axis, sds), eps, branch


def detect_keypoints(cfg: Config, sds: torch.Tensor, sds_mask: torch.Tensor,
                     score: torch.Tensor, axis: torch.Tensor):
    """The detector threshold and FPS keypoints (models/BUFFER.py:255-271):
    (kidx, kvalid, keypoints [2, K, 3], their axes [2, K, 3])."""
    eligible = sds_mask & (score > cfg.point.keypts_th)
    kidx, kvalid = farthest_point_sample_batched(sds, eligible,
                                                 cfg.point.num_keypts)
    gather = lambda a: torch.gather(a, 1, kidx.long()[..., None].expand(-1, -1, 3))
    return kidx, kvalid, gather(sds), gather(axis)


def match_keypoints(kpts, kvalid, s_des, t_des, t_R):
    """Mutual matching (models/BUFFER.py:283-289): (the matches, each source
    keypoint's target index as int64, the target keypoints and frames in
    source order, the mutual count)."""
    m = matching.mutual_matching(s_des, t_des, kvalid[0], kvalid[1])
    tgt = m.tgt_idx.long()
    return m, tgt, kpts[1][tgt], t_R[tgt], torch.sum(m.mutual)


def cost_volume(model: BufferModel, s_equi, t_equi, tgt):
    """The SO(2) azimuth of every match from the cost volume on the reduced
    elevation band, at the full keypoint count whatever the mutual count."""
    band = slice(1, model.cfg.patch.ele_n - 1)
    return model.Inlier(s_equi[:, band], t_equi[:, band][tgt])


def vote(cfg: Config, ss_kpts, tt_kpts, ss_R, tt_R, ind, mutual):
    """Per-match hypotheses and voting (models/BUFFER.py:294-311): (R_h,
    t_h, the winning hypothesis, its inliers)."""
    R_h, t_h = matching.pose_hypotheses(ss_kpts, tt_kpts, ss_R, tt_R, ind,
                                        cfg.patch.azi_n)
    best, vote_inliers = matching.vote_hypotheses(
        ss_kpts, tt_kpts, R_h, t_h, mutual, cfg.patch.azi_n,
        cfg.match.inlier_th)
    return R_h, t_h, best, vote_inliers


def pair_front(model: BufferModel, inputs: PairInputs, draws: Draws,
               mark=lambda: None):
    """The pair up to the RANSAC budget: the pyramid, Ref/Keypt, FPS,
    descriptors, mutual matching, the cost volume and voting.  Returns
    (:class:`Front`, the intermediates dict).  Reads nothing back to the
    host and builds no tensor from host data, so that it can be captured
    as a CUDA graph.  ``mark()`` is called at the start and after each of
    :attr:`StageTimer.FRONT`."""
    cfg = model.cfg

    # 1+2. input normals + conv pyramid, EFCNN axes, DetNet saliency
    mark()
    levels = (None if inputs.lvl1 is None else
              (inputs.lvl1, inputs.lvl1_mask, inputs.lvl2, inputs.lvl2_mask))
    pyr = build_pyramid_and_normals(cfg, inputs.sds, inputs.sds_mask, levels)
    mark()
    axis, eps, branch = reference_axes(model, pyr, inputs.sds)
    score = model.Keypt(pyr, branch)[..., 0]
    mark()

    # 3. detector threshold + FPS keypoints
    kidx, kvalid, kpts, kaxes = detect_keypoints(cfg, inputs.sds,
                                                 inputs.sds_mask, score, axis)
    mark()

    # 4. descriptors of both clouds
    (s_des, s_equi, s_R), (t_des, t_equi, t_R) = describe_both(
        model, cfg, draws, inputs.raw, inputs.raw_mask, kpts, kaxes)
    mark()

    # 5.-7. mutual matching, the cost volume, hypotheses and voting
    m, tgt, tt_kpts, tt_R, num_mutual = match_keypoints(kpts, kvalid, s_des,
                                                        t_des, t_R)
    ind = cost_volume(model, s_equi, t_equi, tgt)
    R_h, t_h, best, vote_inliers = vote(cfg, kpts[0], tt_kpts, s_R, tt_R, ind,
                                        m.mutual)
    mark()

    front = Front(ss_kpts=kpts[0], tt_kpts=tt_kpts, mutual=m.mutual,
                  vote_inliers=vote_inliers, num_mutual=num_mutual,
                  kpts=kpts, kpt_valid=kvalid)
    return front, {
        "pyramid": pyr, "axis": axis, "eps": eps, "score": score,
        "kidx": kidx, "kvalid": kvalid, "kpts": kpts, "kaxes": kaxes,
        "s_des": s_des, "t_des": t_des, "s_equi": s_equi, "t_equi": t_equi,
        "s_R": s_R, "t_R": t_R, "matches": m, "azi_ind": ind,
        "best_hyp": best, "vote_inliers": vote_inliers, "R_h": R_h,
        "t_h": t_h,
    }


def boost_taken(cfg: Config, num_mutual: torch.Tensor) -> bool:
    """Whether a starved match set gets the low-match budget: the one host
    read of a pair, the counterpart of JAX's ``lax.cond`` on the mutual
    count (``buffer_tpu/pipeline/registration.py:279-285``)."""
    return (cfg.static.low_match_boost
            and int(num_mutual) < cfg.static.low_match_th)


def tail_budget(cfg: Config, draws: Draws, boost: bool):
    """(Gumbel noise, IRLS rounds) of the base budget or, with ``boost``,
    of the low-match one: 4x hypotheses and 2x rounds (the reference's
    adaptive budget, models/BUFFER.py:318-324)."""
    if boost:
        return draws.ransac_gumbel_boost, 2 * cfg.static.refine_iters
    return draws.ransac_gumbel, cfg.static.refine_iters


def tail_ransac(cfg: Config, front: Front, gumbel: torch.Tensor):
    """RANSAC on the winner's inliers: (pose [4, 4], inlier mask [K])."""
    return ransac.ransac_pose(gumbel, front.ss_kpts, front.tt_kpts,
                              front.vote_inliers, cfg.match.dist_th,
                              cfg.match.similar_th)


def tail_refine(cfg: Config, front: Front, pose: torch.Tensor, iters: int):
    """With ``test.pose_refine``, ``iters`` IRLS rounds over the mutual
    matches from ``pose``; otherwise ``pose``."""
    if not cfg.test.pose_refine:
        return pose
    th = 1.2 if cfg.data.dataset == "KITTI" else 0.10
    return refine.post_refinement(pose, front.ss_kpts, front.tt_kpts,
                                  front.mutual, th, iters=iters)


def pair_tail(cfg: Config, front: Front, gumbel: torch.Tensor, iters: int,
              mark=lambda: None):
    """RANSAC on the winner's inliers, then (with ``test.pose_refine``)
    ``iters`` IRLS rounds.  Returns (pose [4, 4], number of RANSAC inliers
    []).  Capture-safe like :func:`pair_front`; ``mark()`` is called at the
    start and after each of :attr:`StageTimer.TAIL`."""
    mark()
    pose, ransac_inl = tail_ransac(cfg, front, gumbel)
    mark()
    pose = tail_refine(cfg, front, pose, iters)
    mark()
    return pose, torch.sum(ransac_inl)


_STALE = ("make_register_fn: the model's parameters or buffers are not the "
          "tensors the graphs were captured with (load weights in place, "
          "e.g. load_state_dict, or make a new fn)")


class _Chain:
    """One pair's registration as CUDA graphs for one input signature: the
    front, and a tail for each budget (base and, with
    ``static.low_match_boost``, the low-match one).  :meth:`replay_front`
    copies the caller's tensors into the static input buffers and replays
    the front; :meth:`replay_tail` replays the taken tail.  A
    :class:`_Program` reads the mutual count between the two and copies
    the outputs.

    Each chain has a stream and a graph memory pool of its own.  Its
    warm-up, captures and replays run on its stream, forked from the
    caller's stream and joined back to it, so the cuBLAS workspace that a
    capture bakes in is its stream's alone, and the chains of a program
    replay side by side without sharing memory.  Within a chain the graphs
    replay one after another on its stream, and every tensor a later graph
    reads (the front's outputs, the static inputs) and every graph's
    outputs stay held by the chain, so a graph only reuses pool memory
    that no live output of another occupies.

    A replay runs no Python, so the kernels' launch counts of each graph
    are recorded at capture (``graphs.capture_graph``) and added on each
    replay.  The front and each tail are captured with a
    :class:`StageTimer` of their own, whose events every replay records
    again; a call reads them into its record (:class:`_Calls`).
    ``first``: the eager warm-up's result; ``capture_s``: the host seconds
    that the captures took; the whole build (the eager warm-up and the
    captures) adds to the ``register.capture_s`` counter."""

    def __init__(self, model: BufferModel, dev: torch.device,
                 return_intermediates: bool, inputs: PairInputs, draws: Draws):
        t0 = time.perf_counter()
        self._capture(model, dev, return_intermediates, inputs, draws)
        profiling.count("register.capture_s", time.perf_counter() - t0)

    def _capture(self, model, dev, return_intermediates, inputs, draws):
        self.cfg, self.return_intermediates = model.cfg, return_intermediates
        self.guard = graphs.Guard(
            lambda: (*model.parameters(), *model.buffers()), _STALE)
        self.stream = torch.cuda.Stream(dev)
        self.inputs, self.draws = graphs.empty_like((inputs, draws), dev)
        self.static = (*self.inputs, *self.draws)
        budgets = ((False, True) if self.cfg.static.low_match_boost
                   else (False,))

        def eager():
            # both tails run (first-use builds, handles and attributes
            # happen here, not during capture), so the first call also
            # counts the launches of the tail the pair does not take
            self._load(inputs, draws)
            front, inter = pair_front(model, self.inputs, self.draws)
            boost = boost_taken(self.cfg, front.num_mutual)
            tails = {b: pair_tail(self.cfg, front,
                                  *tail_budget(self.cfg, self.draws, b))
                     for b in budgets}
            return self._outputs(front, inter, *tails[boost])

        with torch.no_grad(), full_fp32():
            self.first = graphs.clone(graphs.warm(eager, dev, self.stream))
            t0 = time.perf_counter()
            self.pool = torch.cuda.graph_pool_handle()
            self.front_timer = StageTimer()
            self.front_graph, (self.front, self.inter), self.front_launches = \
                graphs.capture_graph(lambda: pair_front(
                    model, self.inputs, self.draws, self.front_timer.mark),
                    self.pool, self.stream)
            self.tail_timers = {b: StageTimer() for b in budgets}
            self.tails = {b: graphs.capture_graph(lambda b=b: pair_tail(
                self.cfg, self.front, *tail_budget(self.cfg, self.draws, b),
                self.tail_timers[b].mark), self.pool, self.stream)
                for b in budgets}
            self.capture_s = time.perf_counter() - t0   # host seconds

    def _load(self, inputs: PairInputs, draws: Draws) -> None:
        graphs.load(self.static, (*inputs, *draws))

    def _outputs(self, front: Front, inter: dict, pose, num_inliers):
        result = RegistrationResult(
            pose=pose, num_mutual=front.num_mutual, num_inliers=num_inliers,
            kpts=front.kpts, kpt_valid=front.kpt_valid)
        return (result, inter) if self.return_intermediates else result

    def replay_front(self, inputs: PairInputs, draws: Draws,
                     caller: torch.cuda.Stream, call: _Call) -> None:
        """Loads the pair and replays the front on the chain's stream,
        after the work queued on ``caller``, as a chain of ``call``."""
        self.guard.check()
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            with profiling.span("register.load"):
                self._load(inputs, draws)
            call.front_started(self.front_timer)
            with profiling.span("register.front"):
                self.front_graph.replay()
        cuda.add_launches(self.front_launches)

    def replay_tail(self, boost: bool, call: _Call):
        """Replays the tail of the budget ``boost`` on the chain's stream
        (after its front), as a chain of ``call``; returns the chain's
        outputs, which the caller copies once it has joined the stream."""
        graph, (pose, num_inliers), launches = self.tails[boost]
        call.tail_started(self.tail_timers[boost])
        with torch.cuda.stream(self.stream), profiling.span("register.tail"):
            graph.replay()
        cuda.add_launches(launches)
        return self._outputs(self.front, self.inter, pose, num_inliers)


class _Program:
    """U pairs' :class:`_Chain` s for one input signature, one a pair (U = 1
    for :func:`make_register_fn`), each with its own stream and memory
    pool.  A call forks every chain from the caller's stream and replays
    the U fronts side by side, joins them, reads the U mutual counts in
    one copy to the host (the counterpart of the U ``lax.cond`` of one JAX
    program), replays each chain's taken tail on its stream (a group may
    take both tails), joins again and stacks the outputs on the caller's
    stream.  It records the call's events into ``calls`` and records the
    previous call while the fronts run; while tracing, host spans.
    ``first``: the chains' warm-up results, stacked; ``capture_s``: the
    chains' capture seconds, summed."""

    def __init__(self, model: BufferModel, dev: torch.device,
                 return_intermediates: bool, inputs_list, draws_list):
        self.cfg, self.dev = model.cfg, dev
        self.chains = [_Chain(model, dev, return_intermediates, i, d)
                       for i, d in zip(inputs_list, draws_list)]
        self.first = graphs.stack([c.first for c in self.chains])
        self.capture_s = sum(c.capture_s for c in self.chains)
        self.calls = _Calls()

    def __call__(self, inputs_list, draws_list):
        chains, calls = self.chains, self.calls
        caller = torch.cuda.current_stream(self.dev)
        call = calls.begin(len(chains), caller)
        with profiling.span("register.call", str(call.index)):
            for chain, inputs, draws in zip(chains, inputs_list, draws_list):
                chain.replay_front(inputs, draws, caller, call)
            calls.flush()
            for chain in chains:
                caller.wait_stream(chain.stream)
            call.fronts_done = _event(caller)
            with profiling.span("register.mutual_read"):
                counts = torch.stack([c.front.num_mutual
                                      for c in chains]).tolist()
                boosts = [boost_taken(self.cfg, n) for n in counts]
            outs = [chain.replay_tail(b, call)
                    for chain, b in zip(chains, boosts)]
            call.read_fronts()
            for chain in chains:
                caller.wait_stream(chain.stream)
            with profiling.span("register.outputs"):
                out = graphs.stack(outs)
            calls.end(call, caller)
        return out


def _event(stream) -> torch.cuda.Event:
    """A timing event recorded on ``stream`` now."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


_call_index = itertools.count()     # the calls of the process, in order


class _Call:
    """The events of one call of a compiled program: plain timing events
    on the caller's stream (``start``: call_start at entry;
    ``fronts_done`` after the chains' fronts are joined, before the
    mutual-count read; ``end``: call_end after the outputs are stacked),
    and each chain's stage timers, whose events the graphs record again on
    every replay: a front's first mark is the chain's front_start, a
    tail's first mark its tail_start, both on the chain's stream as the
    graph begins.  The front timers are read in the call itself once the
    mutual counts are on the host (:meth:`read_fronts`), the rest while
    the program's next call's fronts run (:class:`_Calls`)."""

    def __init__(self, chains: int, stream, prev_end):
        self.index, self.t = next(_call_index), time.perf_counter()
        self.start = _event(stream)
        self.prev_end = prev_end
        self.front_timers, self.tail_timers = [], []
        self.fronts_done = self.end = None
        self.front_ms = [None] * chains

    def front_started(self, timer: StageTimer) -> None:
        """A chain's front replays with ``timer``."""
        self.front_timers.append(timer)

    def tail_started(self, timer: StageTimer) -> None:
        """A chain's taken tail replays with ``timer``."""
        self.tail_timers.append(timer)

    def read_fronts(self) -> bool:
        """Reads the front stage spans of every chain whose front is done,
        and with the last chain's the load (never waits); whether all are
        read."""
        for u, timer in enumerate(self.front_timers):
            if self.front_ms[u] is None and timer.ready():
                self.front_ms[u] = timer.stage_ms(wait=False)
                if u == len(self.front_ms) - 1:
                    self.load_ms = self.start.elapsed_time(timer.events[0])
        return all(ms is not None for ms in self.front_ms)

    def record(self) -> dict:
        """The call's record (:func:`~buffer_tpu_torch.utils.profiling.
        call_records`), ``unread`` if its events are not all complete."""
        if self.end is None or not self.end.query() or not self.read_fronts():
            return {"t": self.t, "index": self.index, "unread": True}
        return {
            "t": self.t, "index": self.index, "unroll": len(self.front_ms),
            "stages": [dict(f, **t.stage_ms(wait=False))
                       for f, t in zip(self.front_ms, self.tail_timers)],
            "load_ms": self.load_ms,
            "tail_gap_ms": self.fronts_done.elapsed_time(
                self.tail_timers[0].events[0]),
            "call_gap_ms": (None if self.prev_end is None
                            else self.prev_end.elapsed_time(self.start))}


class _Calls:
    """A program's call accounting: its last :class:`_Call`, held back
    until the next call has launched its fronts (its graphs record their
    timers again from then on), and that call's call_end, the start of the
    next call's gap.  Nothing waits: a call whose events are not complete
    when read is recorded unread.  ``call_records`` reads the last call
    first (:func:`~buffer_tpu_torch.utils.profiling.add_source`)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.pending = self.last_end = None
        profiling.add_source(self)

    def begin(self, chains: int, stream) -> _Call:
        """A call's entry: the :class:`_Call` of ``chains`` chains, its
        call_start recorded on ``stream``.  The last call's fronts are
        read now if they were not (its graphs replay again in this call);
        if they cannot be, it is recorded unread."""
        with self.lock:
            if self.pending is not None and not self.pending.read_fronts():
                self._flush()
            return _Call(chains, stream, self.last_end)

    def _flush(self) -> None:
        if self.pending is not None:
            profiling.add_record(self.pending.record())
            self.pending = None

    def flush(self) -> None:
        """Records the last call: inside a call once its fronts are
        launched (before its tails replay), or between calls."""
        with self.lock:
            self._flush()

    def end(self, call: _Call, stream) -> None:
        """A call's end: records its call_end on ``stream`` and holds it
        back."""
        call.end = _event(stream)
        with self.lock:
            self.pending, self.last_end = call, call.end


def make_register_fn(model: BufferModel, device=None,
                     return_intermediates: bool = False):
    """The compiled registration program (counterpart of
    ``buffer_tpu/pipeline/registration.py:305``'s ``jax.jit`` of
    ``register_pair``): returns ``fn(inputs, draws)``, which returns what
    :func:`register_pair` returns for the same inputs and draws (with
    ``return_intermediates``, also copies of its intermediates dict).

    On the card (the default) it is :func:`make_unrolled_register_fn`'s
    program at U = 1: the pair runs as CUDA graphs, captured once for each
    input signature (shapes, dtypes, which fields are None) on the first
    call, after an eager warm-up whose result that call returns; every
    later call replays them, and ``fn`` drops the result's leading axis.
    The graphs read the model's parameters and buffers in place: loading
    weights in place (``load_state_dict``) carries over, replacing a
    tensor makes the next call raise.  A capture that fails raises;
    nothing falls back to eager.  On the CPU ``fn`` runs
    :func:`register_pair`, the same front and tail, eagerly."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return lambda inputs, draws: register_pair(
            model, inputs, draws, device=dev,
            return_intermediates=return_intermediates)
    group = _group_fn(model, 1, dev, return_intermediates)

    def fn(inputs: PairInputs, draws: Draws):
        return graphs.map_nest(lambda t: t[0], group([inputs], [draws]))

    fn.programs = group.programs
    return fn


def make_unrolled_register_fn(model: BufferModel, unroll: int, device=None,
                              return_intermediates: bool = False):
    """U independent pairs in one program (counterpart of
    ``buffer_tpu/pipeline/registration.py:313``'s
    ``make_unrolled_register_fn``): returns ``fn(inputs_list, draws_list)``,
    both lists of length ``unroll``, which returns a
    :class:`RegistrationResult` with a leading U axis (with
    ``return_intermediates``, also the intermediates dicts stacked so).
    Pair u's result is :func:`make_register_fn`'s on ``inputs_list[u]``
    and ``draws_list[u]``, bit for bit.

    The U chains share no data, so each pair's serial tails (the FPS
    chain, the top-k steps, the IRLS rounds, the per-row gathers) can run
    under the other pairs' heavy work.  On the card (the default) each pair
    is a chain of CUDA graphs with its own stream and memory pool,
    captured on the first call of each input signature after an eager
    warm-up whose results that call returns; a later call replays the U
    fronts side by side, reads the U mutual counts to the host in one copy,
    replays each pair's taken tail on its stream and stacks the outputs
    (:class:`_Program`).  A capture or launch that fails raises; nothing
    falls back to one chain or to eager.  On the CPU ``fn`` runs
    :func:`register_pair` U times."""
    if unroll < 1:
        raise ValueError(f"unroll must be at least 1, not {unroll}")
    return _group_fn(model, unroll, resolve_device(device),
                     return_intermediates)


def _group_fn(model: BufferModel, unroll: int, dev: torch.device,
              return_intermediates: bool):
    """:func:`make_unrolled_register_fn`'s ``fn`` on ``dev``, a
    :class:`_Program` for each input signature (``graphs.cache``)."""

    def key(inputs_list, draws_list) -> tuple:
        """A call's signature, once its arguments are checked."""
        if len(inputs_list) != unroll or len(draws_list) != unroll:
            raise ValueError(f"make_unrolled_register_fn: {len(inputs_list)} "
                             f"inputs and {len(draws_list)} draws for "
                             f"{unroll} pairs")
        _check_model(model, dev)
        return tuple(graphs.signature((*i, *d))
                     for i, d in zip(inputs_list, draws_list))

    if dev.type != "cuda":
        def fn(inputs_list, draws_list):
            key(inputs_list, draws_list)
            return graphs.stack([register_pair(
                model, inputs, draws, device=dev,
                return_intermediates=return_intermediates)
                for inputs, draws in zip(inputs_list, draws_list)])
        fn.programs = {}
        return fn
    return graphs.cache(lambda inputs_list, draws_list: _Program(
        model, dev, return_intermediates, inputs_list, draws_list), key)
