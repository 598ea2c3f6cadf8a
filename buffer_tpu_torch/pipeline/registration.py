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
:func:`make_register_fn` runs the same two parts, :func:`pair_front` and
:func:`pair_tail`, as captured CUDA graphs, as the JAX package runs
``register_pair`` as one jitted program; :func:`make_unrolled_register_fn`
runs U pairs' graphs side by side on streams of their own, as the JAX
package compiles U ``register_pair`` traces into one program.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from buffer_tpu_torch import resolve_device
from buffer_tpu_torch.config import Config
from buffer_tpu_torch.core.numerics import full_fp32
from buffer_tpu_torch.kernels import cuda
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
    reference's ``register_pair``.  A ``timer`` (CUDA only) records an
    event at each stage boundary.  Runs operator by operator;
    :func:`make_register_fn` runs the same front and tail as CUDA graphs."""
    dev = resolve_device(device)
    _check_model(model, dev)
    move = lambda t: None if t is None else t.to(dev)
    inputs = PairInputs(*(move(t) for t in inputs))
    draws = Draws(*(move(t) for t in draws))
    mark = timer.mark if timer is not None else lambda: None
    with torch.no_grad(), full_fp32():
        mark()
        front, inter = pair_front(model, inputs, draws, mark)
        boost = boost_taken(model.cfg, front.num_mutual)
        pose, num_inliers = pair_tail(model.cfg, front,
                                      *tail_budget(model.cfg, draws, boost))
        mark()
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
    as a CUDA graph."""
    cfg = model.cfg

    # 1+2. input normals + conv pyramid, EFCNN axes, DetNet saliency
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


def pair_tail(cfg: Config, front: Front, gumbel: torch.Tensor, iters: int):
    """RANSAC on the winner's inliers, then (with ``test.pose_refine``)
    ``iters`` IRLS rounds.  Returns (pose [4, 4], number of RANSAC inliers
    []).  Capture-safe like :func:`pair_front`."""
    pose, ransac_inl = tail_ransac(cfg, front, gumbel)
    return tail_refine(cfg, front, pose, iters), torch.sum(ransac_inl)


def _signature(inputs: PairInputs, draws: Draws) -> tuple:
    """Shapes and dtypes of every field (None for an absent one): the key
    of a captured program, as jit's cache keys on shapes and dtypes."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype)
                 for t in (*inputs, *draws))


def _clone(x):
    """A copy of every tensor in a nest of tuples, named tuples and dicts."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [_clone(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _stack(xs: list):
    """The nests ``xs`` (equal structure) with every tensor stacked along a
    new leading axis; other leaves are taken from the first."""
    x = xs[0]
    if isinstance(x, torch.Tensor):
        return torch.stack(xs)
    if isinstance(x, dict):
        return {k: _stack([y[k] for y in xs]) for k in x}
    if isinstance(x, tuple):
        items = [_stack(list(ys)) for ys in zip(*xs)]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def capture_graph(run, pool, stream=None):
    """Captures ``run()`` as a CUDA graph in memory pool ``pool`` on
    ``stream`` (default: PyTorch's capture stream); returns
    (the graph, ``run``'s outputs, the kernels' launch counts of one
    replay).  The counts are recorded at capture and taken back, since a
    capture launches nothing; a caller adds them on each replay."""
    graph = torch.cuda.CUDAGraph()
    before = cuda.launch_counts()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            out = run()
    finally:
        after = cuda.launch_counts()
        launches = {k: n - before[k] for k, n in after.items()
                    if n != before[k]}
        cuda.add_launches({k: -n for k, n in launches.items()})
    return graph, out, launches


def _state_ptrs(model: BufferModel) -> tuple:
    return tuple(t.data_ptr() for t in (*model.parameters(), *model.buffers()))


class _GraphProgram:
    """One input signature's registration as CUDA graphs: the front, and a
    tail for each budget (base and, with ``static.low_match_boost``, the
    low-match one).  A call copies the caller's tensors into the static
    input buffers and replays the front (:meth:`replay_front`), reads the
    mutual count, replays the taken tail (:meth:`replay_tail`) and returns
    copies of the outputs.

    Each program has a stream and a graph memory pool of its own.  Its
    warm-up, captures and replays run on its stream, forked from the
    caller's stream and joined back to it, so the cuBLAS workspace that a
    capture bakes in is its stream's alone, and the programs of an
    unrolled group (:func:`make_unrolled_register_fn`) replay side by side
    without sharing memory.  Within a program the graphs replay one after
    another on its stream, and every tensor a later graph reads (the
    front's outputs, the static inputs) and every graph's outputs stay
    held by the program, so a graph only reuses pool memory that no live
    output of another occupies.

    A replay runs no Python, so the kernels' launch counts of each graph
    are recorded at capture (and taken back: a capture launches nothing)
    and added on each replay.  ``capture_s``: the host seconds that the
    captures took."""

    def __init__(self, model: BufferModel, dev: torch.device,
                 return_intermediates: bool, inputs: PairInputs, draws: Draws):
        self.model, self.cfg, self.dev = model, model.cfg, dev
        self.return_intermediates = return_intermediates
        self.state = _state_ptrs(model)
        self.stream = torch.cuda.Stream(dev)
        empty = lambda t: None if t is None else torch.empty(
            t.shape, dtype=t.dtype, device=dev)
        self.inputs = PairInputs(*(empty(t) for t in inputs))
        self.draws = Draws(*(empty(t) for t in draws))
        budgets = ((False, True) if self.cfg.static.low_match_boost
                   else (False,))
        caller = torch.cuda.current_stream(dev)
        self.stream.wait_stream(caller)
        with torch.no_grad(), full_fp32(), torch.cuda.stream(self.stream):
            # warm-up: an eager run, both tails included (first-use builds,
            # handles and attributes happen here, not during capture); its
            # result is the first call's
            self._load(inputs, draws)
            front, inter = pair_front(model, self.inputs, self.draws)
            boost = boost_taken(self.cfg, front.num_mutual)
            tails = {b: pair_tail(self.cfg, front,
                                  *tail_budget(self.cfg, self.draws, b))
                     for b in budgets}
            first = self._outputs(front, inter, *tails[boost])
            caller.wait_stream(self.stream)
            with torch.cuda.stream(caller):
                self.first = _clone(first)
            del front, inter, tails, first

            t0 = time.perf_counter()
            self.pool = torch.cuda.graph_pool_handle()
            self.front_graph, (self.front, self.inter), self.front_launches = \
                capture_graph(lambda: pair_front(model, self.inputs,
                                                 self.draws), self.pool,
                              self.stream)
            self.tails = {b: capture_graph(lambda b=b: pair_tail(
                self.cfg, self.front, *tail_budget(self.cfg, self.draws, b)),
                self.pool, self.stream) for b in budgets}
            self.capture_s = time.perf_counter() - t0   # host seconds

    def _load(self, inputs: PairInputs, draws: Draws) -> None:
        for dst, src in zip((*self.inputs, *self.draws), (*inputs, *draws)):
            if dst is not None:
                dst.copy_(src)

    def _outputs(self, front: Front, inter: dict, pose, num_inliers):
        result = RegistrationResult(
            pose=pose, num_mutual=front.num_mutual, num_inliers=num_inliers,
            kpts=front.kpts, kpt_valid=front.kpt_valid)
        return (result, inter) if self.return_intermediates else result

    def replay_front(self, inputs: PairInputs, draws: Draws,
                     caller: torch.cuda.Stream) -> None:
        """Loads the pair and replays the front on the program's stream,
        after the work queued on ``caller``."""
        if _state_ptrs(self.model) != self.state:
            raise RuntimeError(
                "make_register_fn: the model's parameters or buffers are not "
                "the tensors the graphs were captured with (load weights in "
                "place, e.g. load_state_dict, or make a new fn)")
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            self._load(inputs, draws)
            self.front_graph.replay()
        cuda.add_launches(self.front_launches)

    def replay_tail(self, boost: bool):
        """Replays the tail of the budget ``boost`` on the program's stream
        (after its front); returns the program's outputs, which the caller
        copies once it has joined the stream."""
        graph, (pose, num_inliers), launches = self.tails[boost]
        with torch.cuda.stream(self.stream):
            graph.replay()
        cuda.add_launches(launches)
        return self._outputs(self.front, self.inter, pose, num_inliers)

    def __call__(self, inputs: PairInputs, draws: Draws):
        caller = torch.cuda.current_stream(self.dev)
        self.replay_front(inputs, draws, caller)
        caller.wait_stream(self.stream)
        out = self.replay_tail(boost_taken(self.cfg, self.front.num_mutual))
        caller.wait_stream(self.stream)
        return _clone(out)


class _UnrolledProgram:
    """U pairs' :class:`_GraphProgram` chains, one a pair, each with its own
    stream and memory pool.  A call forks every chain from the caller's
    stream and replays the U fronts side by side, joins them, reads the U
    mutual counts in one copy to the host (the counterpart of the U
    ``lax.cond`` of one JAX program), replays each chain's taken tail on
    its stream (a group may take both tails), joins again and stacks the
    outputs on the caller's stream.  ``capture_s``: the chains' capture
    seconds, summed."""

    def __init__(self, model: BufferModel, dev: torch.device,
                 return_intermediates: bool, inputs_list, draws_list):
        self.cfg, self.dev = model.cfg, dev
        self.chains = [_GraphProgram(model, dev, return_intermediates, i, d)
                       for i, d in zip(inputs_list, draws_list)]
        self.first = _stack([c.first for c in self.chains])
        self.capture_s = sum(c.capture_s for c in self.chains)

    def __call__(self, inputs_list, draws_list):
        caller = torch.cuda.current_stream(self.dev)
        for chain, inputs, draws in zip(self.chains, inputs_list, draws_list):
            chain.replay_front(inputs, draws, caller)
        for chain in self.chains:
            caller.wait_stream(chain.stream)
        counts = torch.stack([c.front.num_mutual for c in self.chains]).tolist()
        outs = [chain.replay_tail(boost_taken(self.cfg, n))
                for chain, n in zip(self.chains, counts)]
        for chain in self.chains:
            caller.wait_stream(chain.stream)
        return _stack(outs)


def make_register_fn(model: BufferModel, device=None,
                     return_intermediates: bool = False):
    """The compiled registration program (counterpart of
    ``buffer_tpu/pipeline/registration.py:305``'s ``jax.jit`` of
    ``register_pair``): returns ``fn(inputs, draws)``, which returns what
    :func:`register_pair` returns for the same inputs and draws (with
    ``return_intermediates``, also clones of its intermediates dict).

    On the card (the default) the pair runs as CUDA graphs, captured once
    for each input signature (shapes, dtypes, which fields are None) on
    the first call, after an eager warm-up whose result that call returns;
    every later call replays them.  The graphs read the model's parameters
    and buffers in place: loading weights in place (``load_state_dict``)
    carries over, replacing a tensor makes the next call raise.  A capture
    that fails raises; nothing falls back to eager.  On the CPU ``fn`` runs
    :func:`register_pair`, the same front and tail, eagerly."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return lambda inputs, draws: register_pair(
            model, inputs, draws, device=dev,
            return_intermediates=return_intermediates)
    programs = {}

    def fn(inputs: PairInputs, draws: Draws):
        _check_model(model, dev)
        key = _signature(inputs, draws)
        if key not in programs:
            program = _GraphProgram(model, dev, return_intermediates, inputs,
                                    draws)
            programs[key] = program
            return program.first
        return programs[key](inputs, draws)

    fn.programs = programs
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
    is a program of CUDA graphs with its own stream and memory pool,
    captured on the first call of each input signature after an eager
    warm-up whose results that call returns; a later call replays the U
    fronts side by side, reads the U mutual counts to the host in one copy,
    replays each pair's taken tail on its stream and stacks the outputs.
    A capture or launch that fails raises; nothing falls back to one chain
    or to eager.  On the CPU ``fn`` runs :func:`register_pair` U times."""
    if unroll < 1:
        raise ValueError(f"unroll must be at least 1, not {unroll}")
    dev = resolve_device(device)
    programs = {}

    def fn(inputs_list, draws_list):
        if len(inputs_list) != unroll or len(draws_list) != unroll:
            raise ValueError(f"make_unrolled_register_fn: {len(inputs_list)} "
                             f"inputs and {len(draws_list)} draws for "
                             f"{unroll} pairs")
        if dev.type != "cuda":
            return _stack([register_pair(
                model, inputs, draws, device=dev,
                return_intermediates=return_intermediates)
                for inputs, draws in zip(inputs_list, draws_list)])
        _check_model(model, dev)
        key = tuple(_signature(i, d) for i, d in zip(inputs_list, draws_list))
        if key not in programs:
            program = _UnrolledProgram(model, dev, return_intermediates,
                                       inputs_list, draws_list)
            programs[key] = program
            return program.first
        return programs[key](inputs_list, draws_list)

    fn.programs = programs
    return fn
