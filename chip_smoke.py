#!/usr/bin/env python3
"""Smoke test of buffer_tpu_torch on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds every
   CUDA kernel from ``buffer_tpu_torch/csrc`` (one nvcc per library, all
   started together).
2. Drives six paths, each with every kernel launch counter set to 0 just
   before it and read just after; every kernel of a path must have run on
   every pair of it:
   * the main path: ``register_pair`` on the shipped 3DMatch preset
     (``knn_band = 4096``) at full width -- 30720/10240/3072 pyramid points,
     65536 raw points, 1500 keypoints, 512-point patches, 1024 RANSAC
     hypotheses with the x4 low-match boost -- on 3 synthetic fragment pairs
     (the surface generator of bench.py) with seeded random weights;
   * the KITTI preset at full width (40960/20480/6144 pyramid points,
     131072 raw points) on 2 synthetic LiDAR pairs, the first a warm-up;
   * the 3DMatch preset with ``knn_band = 0`` (exact unbanded search) on
     1 pair;
   * the 3DMatch preset with ``fused_desc = False`` (the reference's
     sampled descriptor front: stacked patches through
     ``ball_sample_points``, the sampled SPT, the network on the sampled
     patches) on the main path's first 2 pairs, the first a warm-up;
   * the single-cloud FPS entry point ``ops.sampling.farthest_point_sample``
     on the main path's first source cloud;
   * "3DMatch train": stage-sequential training at the same full width
     (``pos_num = 512`` positive pairs a step, 512-point patches, 420 SPT
     anchors, ``voxel_sample = 10``) on the main path's first 2 pairs with
     their ground-truth poses: one ``Trainer`` per stage, Ref -> Desc ->
     Keypt -> Inlier, the others frozen, 3 train steps (the first a
     warm-up) and 1 eval step each.  Every step's launches must equal
     ``TRAIN_STEP``; losses finite; only the active stage's parameters
     move, the frozen stages' running statistics stay; the best and epoch
     checkpoints reload equal.
   Prints ms/pair and a per-stage breakdown (CUDA events) of each preset,
   and ms/step (host clock around a synchronized step) and peak memory
   (``torch.cuda.max_memory_allocated``) of each training stage.
3. Runs the first pair of each preset once more with the plain PyTorch
   versions of the kernels on the card (substituted at the kernels' call
   sites), and the ``fused_desc = False`` pair too: keypoint indices and the
   mutual-match count must be equal, the descriptors within 1e-3 and the
   pose within 1e-4.  One Desc and one Ref
   training step from the same state and draws, with the kernels and with
   the plain versions, under PyTorch's deterministic algorithms: the loss
   within 1e-5 relative, the updated parameters within 1e-6.
4. Holds each kernel against its plain version at the main path's own
   inputs -- every call of the first pair (exact for the banded kNN, the
   banded 1-NN, 1-NN, both FPS entry points and ball sampling; 2e-5 for the
   SPT front; exact for the training front's ball sampling on every call of
   a Desc step) -- and the banded kernels and the batched FPS on the KITTI
   pair too (both timed there as well, the banded calls kernel only; FPS
   per step of its chain too), the exact 1-NN on the KITTI pair's call and
   on both calls of the ``knn_band = 0`` pair, ball sampling of stacked
   points on the ``fused_desc = False`` pair's call, and the banded 1-NN on
   every call of a training step (the pyramid's and the positive-pair
   sampler's), each of these checked and timed; scores the
   banded search against the exact dense search (recall of the true
   in-radius k-NN, > 0.97, and 1-NN index agreement, > 0.99, gated on
   3DMatch, printed for KITTI); times kernel, plain version, the exact
   search the banded kernels stand in for and, where one PyTorch call
   computes the same function, that call (CUDA events after warm-up), and
   ball sampling and both 1-NN kernels also around their C launch alone
   (without the wrapper's preparation); computes each kernel's bound from
   this run's inputs, and, on a line of derived figures of its own, the
   issue floor of the banded kNN, ball sampling and both 1-NN kernels (this
   run's tests x issue slots a test, counted by hand in the inner loops,
   over every fp32 lane at the card's maximum SM clock).

Any failure exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it holds every kernel's
numbers.  Details go to ``chiprun_out/chip_smoke.json``.  Without a CUDA
device the script exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

PEAK_FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
SMS, LANES = 132, 128        # H100 SXM: SMs, fp32 lanes an SM
# issue slots a test, counted by hand in the kernels' inner loops
# (cuobjdump -sass, sm_90a) and not checked by this script: bknn 3 FADD
# (differences), 3 FMUL + 2 FADD (d2), the penalty FADD, the floor FMNMX, a
# LOP3 (row) and 3 FMNMX (winner, runner-up); ball sampling on a miss 3 FMUL
# + 3 FADD, 2 FSETP, a branch and its BSSY/BSYNC; the banded 1-NN as bknn
# with one FMNMX (the column min) in place of three; the exact 1-NN 3 FADD,
# 3 FMUL + 2 FADD, an FSETP and two selects (FSEL, SEL).  Recount them when
# an inner loop changes.
BKNN_SLOTS = 14
BALL_SLOTS = 11
BNN1_SLOTS = 12
NEAREST_SLOTS = 11
N_PAIRS = 3
N_KITTI_PAIRS = 2
KITTI_SEED = 13
RECALL_KNN = 0.97            # tests/test_geom_pallas.py:143
AGREE_NN1 = 0.99
# launches per pair of each kernel on each path (ops/neighbors.py dispatch):
# 3DMatch bands l0/l1 kNN and both pools (l2 has 3072 points, under the
# band), KITTI also l2 (6144 points under its 64-row window); both take the
# banded 1-NN for l0 -> l1 and the exact one for l1 -> l2
PER_PAIR = {
    "3DMatch": {"bknn": 4, "bnn1": 1, "nearest": 1, "fps": 1,
                "ball_sample": 1, "spt_pooled": 1},
    "KITTI": {"bknn": 5, "bnn1": 1, "nearest": 1, "fps": 1, "ball_sample": 1,
              "spt_pooled": 1},
    "3DMatch knn_band=0": {"nearest": 2, "fps": 1, "ball_sample": 1,
                           "spt_pooled": 1},
    "3DMatch fused_desc=False": {"bknn": 4, "bnn1": 1, "nearest": 1, "fps": 1,
                                 "ball_sample_points": 1},
    "farthest_point_sample": {"fps_single": 1},
}
TRAIN_PAIRS = 2
TRAIN_STEPS = 3
STAGES = ("Ref", "Desc", "Keypt", "Inlier")
# launches per training (and eval) step on the 3DMatch preset: the pyramid
# as above plus the banded 1-NN of the positive-pair sampler (30720 target
# points > 2 * 4096), and both clouds' patches in one launch past Ref
TRAIN_STEP = {"Ref": {"bknn": 4, "bnn1": 2, "nearest": 1}}
TRAIN_STEP.update({s: dict(TRAIN_STEP["Ref"], ball_sample_points=1)
                   for s in STAGES[1:]})


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's maximum SM clock as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def issue_floor_ms(tests: float, slots: int, clock_hz: float) -> float:
    """Milliseconds of pure issue: tests x slots over every fp32 lane."""
    return 1e3 * tests * slots / (SMS * LANES * clock_hz)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of flops over the fp32 peak and
    bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_launches(path: str, rose: dict, want: dict = None) -> None:
    """Every kernel of the path ran on this pair (or step) as often as the
    dispatch says, and no other kernel ran."""
    want = PER_PAIR[path] if want is None else want
    if {k: v for k, v in rose.items() if v or k in want} != want:
        raise RuntimeError(f"{path}: launches {rose}, expected {want}")


@contextlib.contextmanager
def capture(mod, name: str, calls: list):
    """Within the block every call of ``mod.name`` is recorded in ``calls``
    as its positional arguments."""
    fn = getattr(mod, name)

    def recorded(*args):
        calls.append(args)
        return fn(*args)

    setattr(mod, name, recorded)
    try:
        yield
    finally:
        setattr(mod, name, fn)


def drive(path: str, model, dev, pairs, draws):
    """register_pair over ``pairs``; every count set to 0 just before and
    read just after.  Returns (launches, ms per pair, results, stage ms)."""
    import torch
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.pipeline import registration
    cuda.reset_launches()
    per_pair, results, stages = [], [], []
    for inputs, dr in zip(pairs, draws):
        before = cuda.launch_counts()
        timer = registration.StageTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = registration.register_pair(model, inputs, dr, device=dev,
                                         timer=timer)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        after = cuda.launch_counts()
        check_launches(path, {k: after[k] - before[k] for k in after})
        per_pair.append(ms)
        results.append(res)
        stages.append(timer.stage_ms())
    return cuda.launch_counts(), per_pair, results, stages


def path_line(path: str, cfg, launches, per_pair, results, stages, prep_s,
              pair0) -> dict:
    """Checks the outputs of a driven path and summarizes it."""
    import torch
    for r in results:
        if not torch.isfinite(r.pose).all():
            raise RuntimeError(f"{path}: non-finite pose")
        if r.pose.shape != (4, 4) or r.kpts.shape != (2, cfg.point.num_keypts, 3):
            raise RuntimeError(f"{path}: unexpected output shapes")
    n_kpts = [[int(v) for v in r.kpt_valid.sum(1)] for r in results]
    if min(min(n) for n in n_kpts) <= 0:
        raise RuntimeError(f"{path}: no eligible keypoints: {n_kpts}")
    warm = per_pair[1:] or per_pair
    steady = stages[1:] or stages
    line = {"path": path, "pairs": len(per_pair), "host_prep_s": prep_s,
            "valid_points": {f: [int(m.sum()) for m in getattr(pair0, f)]
                             for f in ("raw_mask", "sds_mask", "lvl1_mask",
                                       "lvl2_mask")},
            "ms_per_pair": sum(warm) / len(warm), "first_pair_ms": per_pair[0],
            "per_pair_ms": per_pair,
            "stage_ms": {k: sum(s[k] for s in steady) / len(steady)
                         for k in stages[0]},
            "eligible_keypoints": n_kpts,
            "num_mutual": [int(r.num_mutual) for r in results],
            "num_inliers": [int(r.num_inliers) for r in results],
            "launches": launches}
    print(json.dumps(line))
    return line


def plain_path_check(path: str, model, dev, inputs, draws, kernel_run) -> dict:
    """The pair once more through the plain versions: the same keypoints and
    mutual count, descriptors within 1e-3, pose within 1e-4."""
    import torch
    from buffer_tpu_torch.kernels import cuda, sites
    from buffer_tpu_torch.pipeline import registration
    res_k, inter_k = kernel_run
    before = cuda.launch_counts()
    with sites.plain_versions():
        res_p, inter_p = registration.register_pair(
            model, inputs, draws, device=dev, return_intermediates=True)
    if cuda.launch_counts() != before:
        raise RuntimeError(f"{path}: a kernel ran on the plain path")
    if not torch.equal(inter_k["kidx"], inter_p["kidx"]):
        raise RuntimeError(f"{path}: keypoint indices differ between kernels "
                           "and plain")
    pose_err = float((res_k.pose - res_p.pose).abs().max())
    desc_err = max(float((inter_k[n] - inter_p[n]).abs().max())
                   for n in ("s_des", "t_des"))
    if (int(res_k.num_mutual) != int(res_p.num_mutual) or pose_err > 1e-4
            or desc_err > 1e-3):
        raise RuntimeError(f"{path}: kernel and plain paths disagree: mutual "
                           f"{int(res_k.num_mutual)} vs {int(res_p.num_mutual)}, "
                           f"pose {pose_err}, descriptors {desc_err}")
    out = {"path": path, "kidx_equal": True,
           "num_mutual": int(res_k.num_mutual), "desc_max_abs_err": desc_err,
           "pose_max_abs_err": pose_err}
    print(json.dumps({"plain_path_check": out}))
    return out


def recorded_run(model, dev, inputs, draws,
                 names=("banded_knn_cuda", "banded_nn1_cuda", "nearest_cuda")):
    """register_pair of one pair with the arguments of every call of the
    named kernel wrappers (as ``ops.neighbors`` calls them) recorded:
    (result, intermediates, {wrapper: [args]})."""
    from buffer_tpu_torch.ops import neighbors
    from buffer_tpu_torch.pipeline import registration
    calls = {name: [] for name in names}
    with contextlib.ExitStack() as stack:
        for name, store in calls.items():
            stack.enter_context(capture(neighbors, name, store))
        res, inter = registration.register_pair(
            model, inputs, draws, device=dev, return_intermediates=True)
    return res, inter, calls


def knn_recall(got, exact, query_valid, r2_prefix=None) -> float:
    """Mean share of the true in-radius k-NN (the exact search's valid
    slots) present in the banded result, over valid queries that have any.
    ``r2_prefix`` restricts both to d2 <= r2 (the radius-free level-0 list
    is scored on the prefix the conv uses)."""
    import torch
    d, i, v = got
    de, ie, ve = exact
    if r2_prefix is not None:
        v = v & (d <= r2_prefix)
        ve = ve & (de <= r2_prefix)
    i = torch.where(v, i, torch.full_like(i, -1))
    hit = ((ie[..., :, None] == i[..., None, :]).any(-1) & ve).sum(-1)
    n = ve.sum(-1)
    ok = query_valid & (n > 0)
    return float((hit[ok].float() / n[ok].float()).mean())


def banded_entries(calls, cfg, time_plain: bool = True):
    """Checks the banded kernels bit-equal to their plain versions on every
    recorded call, scores them against the exact search and times them
    (the plain versions and the exact search too when ``time_plain``).
    Returns per-kernel sums and per-call rows."""
    import torch
    from buffer_tpu_torch.kernels import knn_cuda
    from buffer_tpu_torch.ops import neighbors
    r0 = cfg.data.voxel_size_0 * cfg.point.conv_radius
    rows, sums = [], {}

    def add(kernel, row):
        rows.append(row)
        s = sums.setdefault(kernel, {"calls": 0, "ms": 0.0, "plain_ms": 0.0,
                                     "exact_ms": 0.0, "launch_ms": 0.0,
                                     "flops": 0.0, "bytes": 0.0, "tests": 0,
                                     "score": []})
        s["calls"] += 1
        for key in ("ms", "plain_ms", "exact_ms", "launch_ms", "flops", "bytes",
                    "tests"):
            s[key] += row.get(key) or 0.0
        s["score"].append(row["score"])

    for q, s, sv, qv, k, radius, wr in calls["banded_knn_cuda"]:
        args = (q, s, sv, qv, k, radius, wr)
        got = knn_cuda.banded_knn_cuda(*args)
        want = knn_cuda.banded_knn_plain(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"bknn: kernel and plain differ at Q={q.shape[1]}"
                               f" S={s.shape[1]} k={k} radius={radius}")
        exact = neighbors.radius_knn(q, s, sv, k, radius if radius else r0)
        score = knn_recall(got, exact, qv, None if radius else r0 * r0)
        B, Q, S = q.shape[0], q.shape[1], s.shape[1]
        _, LW = knn_cuda.window_rows(S, wr)
        row = {"kernel": "bknn", "Q": Q, "S": S, "k": k, "radius": radius,
               "window_rows": LW, "score": score,
               "tests": B * Q * LW * knn_cuda.NSEG,
               "flops": B * Q * LW * knn_cuda.NSEG * 8,
               "bytes": B * (Q * 13 + S * 13 + Q * k * 9),
               "plan": knn_cuda.bknn_plan(B, Q, S, LW)}
        row["ms"] = cuda_ms(lambda: knn_cuda.banded_knn_cuda(*args), 20)
        if time_plain:
            row["plain_ms"] = cuda_ms(lambda: knn_cuda.banded_knn_plain(*args), 2)
            row["exact_ms"] = cuda_ms(
                lambda: neighbors.radius_knn(q, s, sv, k, radius), 3)
        add("bknn", row)

    for q, s, sv, qv in calls["banded_nn1_cuda"]:
        got = knn_cuda.banded_nn1_cuda(q, s, sv, qv)
        want = knn_cuda.banded_nn1_plain(q, s, sv, qv)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError("bnn1: kernel and plain differ")
        _, ie = neighbors.nearest_cuda(q, s, sv)
        score = float((got[1] == ie)[qv].float().mean())
        B, Q, S = q.shape[0], q.shape[1], s.shape[1]
        _, LW = knn_cuda.window_rows(S, knn_cuda.NN1_WIN_ROWS)
        row = {"kernel": "bnn1", "Q": Q, "S": S, "window_rows": LW,
               "score": score, "tests": B * Q * LW * knn_cuda.NSEG,
               "flops": B * Q * LW * knn_cuda.NSEG * 8,
               "bytes": B * (Q * 13 + S * 13 + Q * 8),
               "plan": knn_cuda.bnn1_plan(B, Q, S)}
        row["ms"] = cuda_ms(lambda: knn_cuda.banded_nn1_cuda(q, s, sv, qv), 20)
        row["launch_ms"] = cuda_ms(knn_cuda.bnn1_launcher(
            q, s, sv, qv, [torch.empty_like(x) for x in got]), 20)
        if time_plain:
            row["plain_ms"] = cuda_ms(
                lambda: knn_cuda.banded_nn1_plain(q, s, sv, qv), 2)
            row["exact_ms"] = cuda_ms(lambda: cdist_nn(q, s, sv), 3)
        add("bnn1", row)
    for row in rows:
        print(json.dumps({"banded_call": row}))
    return sums, rows


def cdist_nn(q, s, valid, chunk=4096):
    """Exact 1-NN by one PyTorch call per query chunk (``torch.cdist`` and
    ``min``): the yardstick of the 1-NN kernel."""
    import torch
    far = torch.where(valid[..., None], s, torch.full_like(s, 1e6))
    return [torch.cdist(q[:, i:i + chunk], far).min(dim=2)
            for i in range(0, q.shape[1], chunk)]


def state_of(model, stage: str) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.startswith(stage + ".")}


def counted(fn, name: str, want: dict):
    """fn() with the launches it makes checked against ``want``; returns
    (result, host ms around the synchronized call, the launches it made)."""
    import torch
    from buffer_tpu_torch.kernels import cuda
    before = cuda.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    after = cuda.launch_counts()
    rose = {k: after[k] - before[k] for k in after}
    check_launches(name, rose, want)
    return out, ms, rose


def train_path(dev, cfg, batches, save_dir: str, gen) -> dict:
    """Stage-sequential training through the ``Trainer`` entry points; every
    count set to 0 just before and read just after.  Returns the summary
    (raises on any failed check)."""
    import torch
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.train import checkpoint
    from buffer_tpu_torch.train.trainer import BEST_METRIC, Trainer
    from buffer_tpu_torch.utils.logging import MetricLogger

    model = BufferModel(cfg, seed=0).to(dev)
    logger = MetricLogger(os.path.join(save_dir, "metrics.jsonl"), echo=False)
    stages = []
    cuda.reset_launches()
    for stage in STAGES:
        trainer = Trainer(cfg, model, stage, save_dir, logger=logger, device=dev)
        lr = trainer.set_epoch_lr(0)
        before = {s: state_of(model, s) for s in STAGES}
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        for i in range(TRAIN_STEPS):
            draws = make_train_draws(cfg, gen, dev)
            (loss, stats), t, step_launches = counted(
                lambda: trainer.step(batches[i % len(batches)], draws),
                f"train {stage}", TRAIN_STEP[stage])
            if not all(bool(torch.isfinite(v)) for v in stats.values()):
                raise RuntimeError(f"train {stage}: non-finite stats {stats}")
            if float(stats["grad_finite"]) != 1.0:
                raise RuntimeError(f"train {stage}: a step was skipped")
            ms.append(t)
            losses.append(float(loss))
        res, eval_ms, _ = counted(lambda: trainer.evaluate(batches[:1], gen),
                                  f"eval {stage}", TRAIN_STEP[stage])
        if not all(math.isfinite(v) for v in res.values()):
            raise RuntimeError(f"eval {stage}: non-finite stats {res}")
        trainer.end_epoch(0, res)
        peak = torch.cuda.max_memory_allocated()
        after = {s: state_of(model, s) for s in STAGES}
        moved = [k for k, v in after[stage].items() if "running" not in k
                 and "num_batches" not in k and not torch.equal(v, before[stage][k])]
        if not moved:
            raise RuntimeError(f"train {stage}: no parameter moved")
        for s in STAGES:
            if s != stage and any(not torch.equal(v, before[s][k])
                                  for k, v in after[s].items()):
                raise RuntimeError(f"train {stage}: frozen stage {s} changed")
        sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        for name in ("best", 0):
            got = checkpoint.load(trainer.checkpoint_path(name))
            if set(got) != set(sd) or any(not torch.equal(got[k], sd[k])
                                          for k in sd):
                raise RuntimeError(f"train {stage}: checkpoint {name} does "
                                   "not reload equal")
        warm = ms[1:]
        line = {"path": "3DMatch train", "stage": stage, "lr": lr,
                "steps": TRAIN_STEPS, "first_step_ms": ms[0],
                "ms_per_step": sum(warm) / len(warm), "step_ms": ms,
                "eval_ms": eval_ms, "peak_mem_bytes": peak, "losses": losses,
                "eval": res, "metric": BEST_METRIC[stage],
                "params_moved": len(moved),
                "launches_last_step": {k: v for k, v in step_launches.items()
                                       if v}}
        print(json.dumps(line))
        stages.append(line)
    return {"model": model, "stages": stages, "launches": cuda.launch_counts()}


def plain_train_check(stage, model, cfg, batch, draws, dev, save_dir) -> dict:
    """One training step of ``stage`` from the same state and draws with the
    kernels and with the plain versions, under PyTorch's deterministic
    algorithms: loss within 1e-5 relative, updated parameters within 1e-6."""
    import copy
    import torch
    from buffer_tpu_torch.kernels import cuda, sites
    from buffer_tpu_torch.train.trainer import Trainer
    from buffer_tpu_torch.utils.logging import MetricLogger
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for plain in (False, True):
            m = copy.deepcopy(model)
            tr = Trainer(cfg, m, stage, save_dir, device=dev,
                         logger=MetricLogger(None, echo=False))
            before = cuda.launch_counts()
            with sites.plain_versions() if plain else contextlib.nullcontext():
                loss, _ = tr.step(batch, draws)
            if plain and cuda.launch_counts() != before:
                raise RuntimeError(f"train {stage}: a kernel ran on the plain path")
            runs.append((float(loss), state_of(m, stage)))
    finally:
        torch.use_deterministic_algorithms(False)
    (lk, pk), (lp, pp) = runs
    loss_rel = abs(lk - lp) / max(abs(lp), 1e-30)
    param_err = max(float((pk[k].float() - pp[k].float()).abs().max())
                    for k in pk if pk[k].is_floating_point())
    out = {"path": "3DMatch train", "stage": stage, "loss_kernels": lk,
           "loss_plain": lp, "loss_rel_err": loss_rel,
           "param_max_abs_err": param_err}
    print(json.dumps({"plain_train_check": out}))
    if loss_rel > 1e-5 or param_err > 1e-6:
        raise RuntimeError(f"train {stage}: kernel and plain steps disagree: {out}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    # cuBLAS's deterministic mode (plain_train_check) needs its workspace
    # fixed before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    print(card_line())
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    from buffer_tpu_torch.config import kitti_cfg, threedmatch_cfg
    summary = run(torch.device("cuda", 0), threedmatch_cfg(), kitti_cfg(),
                  N_PAIRS, N_KITTI_PAIRS)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"kernels": summary["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev, cfg, kcfg, n_pairs: int, n_kitti: int) -> dict:
    """Build, drive every path, check each against its plain path and
    measure each kernel; returns the summary (raises on any failure)."""
    import torch
    from buffer_tpu_torch.config import unbanded
    from buffer_tpu_torch.data.synthetic import lidar_pair, surface_pair
    from buffer_tpu_torch.kernels import cuda, fps_cuda, geom_cuda
    from buffer_tpu_torch.models import patch_embedder as pe
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.ops import sampling
    from buffer_tpu_torch.pipeline import registration

    t0 = time.time()
    logs = cuda.build_all()
    build_s = time.time() - t0
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln or "entry function" in ln]
             for k, v in logs.items()}
    print(json.dumps({"build_s": build_s, "ptxas": ptxas}))

    p = cfg.patch
    gen = torch.Generator(device=dev).manual_seed(0)

    def pairs_of(c, make, seeds):
        t = time.time()
        made = [make(c, s, dev) for s in seeds]
        return ([m[0] for m in made], [m[1] for m in made],
                [registration.make_draws(c, gen, dev) for _ in made],
                time.time() - t)

    # ---- the main path: the shipped 3DMatch preset ----------------------
    model = BufferModel(cfg, seed=0).to(dev)
    pairs, poses_gt, draws, prep_s = pairs_of(cfg, surface_pair, range(n_pairs))
    counts, *rest = drive("3DMatch", model, dev, pairs, draws)
    main_line = path_line("3DMatch", cfg, counts, *rest, prep_s, pairs[0])

    # ---- KITTI at full width --------------------------------------------
    kmodel = BufferModel(kcfg, seed=0).to(dev)
    kpairs, kposes_gt, kdraws, kprep_s = pairs_of(
        kcfg, lidar_pair, range(KITTI_SEED, KITTI_SEED + n_kitti))
    kcounts, *rest = drive("KITTI", kmodel, dev, kpairs, kdraws)
    kitti_line = path_line("KITTI", kcfg, kcounts, *rest, kprep_s, kpairs[0])

    # ---- the exact unbanded path of slice 1 -----------------------------
    ucfg = unbanded(cfg)
    umodel = BufferModel(ucfg, seed=0).to(dev)
    upairs, _, udraws, uprep_s = pairs_of(ucfg, surface_pair, [0])
    ucounts, *rest = drive("3DMatch knn_band=0", umodel, dev, upairs, udraws)
    band0_line = path_line("3DMatch knn_band=0", ucfg, ucounts, *rest, uprep_s,
                           upairs[0])

    # ---- the sampled descriptor front (fused_desc = False) --------------
    scfg = cfg.replace(static=dataclasses.replace(cfg.static, fused_desc=False))
    smodel = BufferModel(scfg, seed=0).to(dev)
    scounts, *rest = drive("3DMatch fused_desc=False", smodel, dev, pairs[:2],
                           draws[:2])
    sampled_line = path_line("3DMatch fused_desc=False", scfg, scounts, *rest,
                             prep_s, pairs[0])

    # ---- the first pair of each preset with every call recorded ---------
    res_k, inter_k, calls = recorded_run(model, dev, pairs[0], draws[0])
    kres_k, kinter_k, kcalls = recorded_run(kmodel, dev, kpairs[0], kdraws[0])
    # the calls that the knn_band = 0 and fused_desc = False paths make at
    # shapes of their own: the exact 1-NN's l0 -> l1 and l1 -> l2, and the
    # sampled front's ball sampling of both clouds' keypoints
    _, _, ucalls = recorded_run(umodel, dev, upairs[0], udraws[0],
                                ("nearest_cuda",))
    sres_k, sinter_k, scalls = recorded_run(smodel, dev, pairs[0], draws[0],
                                            ("ball_sample_points_cuda",))
    for path, got, want in (
            ("3DMatch knn_band=0", ucalls["nearest_cuda"], "nearest"),
            ("3DMatch fused_desc=False", scalls["ball_sample_points_cuda"],
             "ball_sample_points")):
        if len(got) != PER_PAIR[path][want]:
            raise RuntimeError(f"{path}: {len(got)} recorded {want} calls")

    # ---- the single-cloud FPS entry point -------------------------------
    K = cfg.point.num_keypts
    sds0 = pairs[0].sds[0]
    elig0 = pairs[0].sds_mask[0] & (inter_k["score"][0] > cfg.point.keypts_th)
    cuda.reset_launches()
    fidx, fvalid = sampling.farthest_point_sample(sds0, elig0, K)
    torch.cuda.synchronize()
    fcounts = cuda.launch_counts()
    check_launches("farthest_point_sample", fcounts)
    if int(fvalid.sum()) != min(K, int(elig0.sum())):
        raise RuntimeError("farthest_point_sample: wrong valid count")

    # ---- stage-sequential training at full width -----------------------
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.train.trainer import TrainBatch, eval_step
    save_dir = str(cuda.BUILD_DIR / "train_smoke")
    shutil.rmtree(save_dir, ignore_errors=True)
    batches = [TrainBatch(inp, torch.as_tensor(T, device=dev))
               for inp, T in zip(pairs[:TRAIN_PAIRS], poses_gt[:TRAIN_PAIRS])]
    tgen = torch.Generator(device=dev).manual_seed(1)
    train = train_path(dev, cfg, batches, save_dir, tgen)
    tmodel = train["model"]

    # ---- plain-path checks ----------------------------------------------
    checks = [plain_path_check("3DMatch", model, dev, pairs[0], draws[0],
                               (res_k, inter_k)),
              plain_path_check("KITTI", kmodel, dev, kpairs[0], kdraws[0],
                               (kres_k, kinter_k)),
              plain_path_check("3DMatch fused_desc=False", smodel, dev,
                               pairs[0], draws[0], (sres_k, sinter_k))]
    tdraws = make_train_draws(cfg, tgen, dev)
    train_checks = [plain_train_check(st, tmodel, cfg, batches[0], tdraws, dev,
                                      save_dir) for st in ("Desc", "Ref")]

    # ---- the neighbour and ball calls of one (eval) training step -------
    from buffer_tpu_torch.ops import neighbors
    ball_calls, tbnn1_calls = [], []
    with capture(neighbors, "ball_sample_points_cuda", ball_calls), \
            capture(neighbors, "banded_nn1_cuda", tbnn1_calls):
        eval_step(tmodel, "Desc", batches[0], tdraws, 1.05, dev)
    if len(ball_calls) != 1 or len(tbnn1_calls) != 2:
        raise RuntimeError(f"training step: {len(ball_calls)} ball and "
                           f"{len(tbnn1_calls)} banded 1-NN calls")

    # ---- each kernel against its plain version at the main-path inputs --
    kernels, reference = [], {}
    clock = sm_clock_hz()
    floors = {}

    def floor(name, slots, **tests):
        floors[name] = {"slots_a_test": slots, **tests, **{
            "issue_floor_ms" + key[5:]: issue_floor_ms(n, slots, clock)
            for key, n in tests.items()}}

    def entry(kern, launches, err, ms, plain_ms, flops, nbytes, lib_ms,
              **extra):
        b_ms, b_by = bound(flops, nbytes)
        e = {"name": kern.name, "route": "cuda", "source": kern.source,
             "replaces": kern.replaces, "launches": launches,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, **extra}
        print(json.dumps(e))
        kernels.append(e)

    # 1. exact 1-NN: every call of the pair (the l1 -> l2 upsample), and the
    # KITTI pair's and the knn_band = 0 pair's (checked and timed); around
    # the wrapper and around the C launch alone
    def nn_check(args):
        err = 0.0
        for a in args:
            (dk, ik), (dp, ip) = (geom_cuda.nearest_cuda(*a),
                                  geom_cuda.nearest_plain(*a))
            if not torch.equal(ik, ip) or not torch.equal(dk, dp):
                raise RuntimeError("nearest: kernel and plain differ at "
                                   f"{tuple(a[0].shape)} x {tuple(a[1].shape)}")
            err = max(err, float((dk - dp).abs().max()))
        return err

    def nn_launch_ms(a):
        outs = [torch.empty(a[0].shape[:2], device=dev),
                torch.empty(a[0].shape[:2], dtype=torch.int32, device=dev)]
        return cuda_ms(geom_cuda.nearest_launcher(*a, outs), 20)

    nn_tests = lambda args: sum(a[0].shape[0] * a[0].shape[1] * a[1].shape[1]
                                for a in args)
    nn_args, knn_args = calls["nearest_cuda"], kcalls["nearest_cuda"]
    unn_args = ucalls["nearest_cuda"]
    err = max(nn_check(nn_args), nn_check(knn_args), nn_check(unn_args))
    nn_shapes = lambda args: [[*a[0].shape[:2], a[1].shape[1]] for a in args]
    nn_plans = lambda args: [geom_cuda.nearest_plan(
        a[0].shape[0], a[0].shape[1], a[1].shape[1]) for a in args]
    entry(geom_cuda.NEAREST, counts["nearest"], err,
          sum(cuda_ms(lambda a=a: geom_cuda.nearest_cuda(*a), 20) for a in nn_args),
          sum(cuda_ms(lambda a=a: geom_cuda.nearest_plain(*a), 3) for a in nn_args),
          8 * nn_tests(nn_args),
          sum(a[0].numel() * 4 + a[1].numel() * 4 + a[2].numel()
              + a[0].shape[0] * a[0].shape[1] * 8 for a in nn_args),
          sum(cuda_ms(lambda a=a: cdist_nn(*a), 5) for a in nn_args),
          launch_ms=sum(nn_launch_ms(a) for a in nn_args),
          plan=nn_plans(nn_args),
          ms_kitti=sum(cuda_ms(lambda a=a: geom_cuda.nearest_cuda(*a), 20)
                       for a in knn_args),
          launch_ms_kitti=sum(nn_launch_ms(a) for a in knn_args),
          calls_kitti=nn_shapes(knn_args), plan_kitti=nn_plans(knn_args),
          ms_band0=[cuda_ms(lambda a=a: geom_cuda.nearest_cuda(*a), 20)
                    for a in unn_args],
          launch_ms_band0=[nn_launch_ms(a) for a in unn_args],
          calls_band0=nn_shapes(unn_args), plan_band0=nn_plans(unn_args),
          ptxas=ptxas["nearest"])
    floor("nearest", NEAREST_SLOTS, tests=nn_tests(nn_args),
          tests_kitti=nn_tests(knn_args), tests_band0=nn_tests(unn_args))

    # 2. batched FPS on the detector-eligible points, at the 3DMatch pair's
    # shape and (checked and timed, not in the bound) the KITTI pair's
    def fps_check(path, sds, elig, kidx, n):
        ik = fps_cuda.fps_cuda_batched(sds, elig, n)
        ip = fps_cuda.fps_plain(sds, elig, n)
        if not torch.equal(ik, ip):
            raise RuntimeError(f"fps ({path}): kernel and plain indices differ")
        if not torch.equal(ik, kidx):
            raise RuntimeError(f"fps ({path}): not the path's keypoints")
        return float((ik - ip).abs().max())

    sds = pairs[0].sds
    elig = pairs[0].sds_mask & (inter_k["score"] > cfg.point.keypts_th)
    fps_err = fps_check("3DMatch", sds, elig, inter_k["kidx"], K)
    ksds = kpairs[0].sds
    kelig = kpairs[0].sds_mask & (kinter_k["score"] > kcfg.point.keypts_th)
    KK_fps = kcfg.point.num_keypts
    fps_err = max(fps_err, fps_check("KITTI", ksds, kelig, kinter_k["kidx"],
                                     KK_fps))
    B, N = elig.shape
    fps_ms = cuda_ms(lambda: fps_cuda.fps_cuda_batched(sds, elig, K), 5)
    entry(fps_cuda.FPS, counts["fps"], fps_err, fps_ms,
          cuda_ms(lambda: fps_cuda.fps_plain(sds, elig, K), 1),
          B * (K - 1) * N * 9, B * N * 13 + B * K * 4, None,
          per_step_us=1e3 * fps_ms / (K - 1), plan=fps_cuda.fps_plan(N),
          max_active_clusters=fps_cuda.fps_max_active_clusters(
              fps_cuda.fps_plan(N)),
          ms_kitti=cuda_ms(
              lambda: fps_cuda.fps_cuda_batched(ksds, kelig, KK_fps), 5),
          kitti_shape=list(kelig.shape), plan_kitti=fps_cuda.fps_plan(
              kelig.shape[1]), ptxas=ptxas["fps"])

    # 3. ball sampling of both clouds' patches: timed around the wrapper
    # and around the C launch alone (pack and select, without the wrapper's
    # preparation)
    def ball_launch_ms(kern, args, outs):
        return cuda_ms(geom_cuda.ball_launcher(kern, *args, outs), 10)

    ball_args = (inter_k["kpts"], pairs[0].raw, pairs[0].raw_mask,
                 draws[0].ball_prio, p.des_r, p.num_points_per_patch)
    outk = geom_cuda.ball_sample_planes_cuda(*ball_args)
    outp = geom_cuda.ball_sample_planes_plain(*ball_args)
    for a, b in zip(outk, outp):
        if not torch.equal(a, b):
            raise RuntimeError("ball_sample: kernel and plain outputs differ")
    Bq, Q = ball_args[0].shape[:2]
    Nr, k = pairs[0].raw.shape[1], p.num_points_per_patch
    entry(geom_cuda.BALL, counts["ball_sample"],
          max(float((a.float() - b.float()).abs().max()) for a, b in zip(outk, outp)),
          cuda_ms(lambda: geom_cuda.ball_sample_planes_cuda(*ball_args), 10),
          cuda_ms(lambda: geom_cuda.ball_sample_planes_plain(*ball_args), 2),
          Bq * Q * Nr * 7, Bq * (Nr * 17 + Q * 12 + Q * k * 13), None,
          launch_ms=ball_launch_ms(geom_cuda.BALL, ball_args,
                                   [torch.empty_like(outk[0]) for _ in range(3)]
                                   + [torch.empty_like(outk[3]).view(torch.uint8)]),
          plan=geom_cuda.ball_plan(Bq, Q, Nr // (k // 2), k // 2),
          valid_slots=int(outk[3].sum()), ptxas=ptxas["ball_sample"])
    floor("ball_sample", BALL_SLOTS, tests=Bq * Q * Nr)

    # 4. the fused SPT front of both clouds' keypoints
    kpts = inter_k["kpts"]
    x, y, z = pe.extract_patch_planes(pairs[0].raw, pairs[0].raw_mask,
                                      draws[0].ball_prio, kpts, p.des_r, k)
    planes = tuple(((c - kpts[..., d:d + 1]) / p.des_r).reshape(2 * K, -1)
                   for d, c in enumerate((x, y, z)))
    R_all = torch.cat([inter_k["s_R"], inter_k["t_R"]])
    W_all, b_eff, f0 = pe.fold_point_mlp(model.Desc, p.azi_n)
    spt_args = (W_all, b_eff, f0, draws[0].spt_prio, planes, R_all, p.rad_n,
                p.azi_n, p.ele_n, p.delta / p.rad_n, p.voxel_sample)
    with torch.no_grad():
        spk = geom_cuda.spt_pooled_cuda(*spt_args)
        spp = geom_cuda.spt_pooled_plain(*spt_args)
        spt_err = float((spk - spp).abs().max())
        if spt_err > 2e-5:
            raise RuntimeError(f"spt_pooled: kernel and plain differ by {spt_err}")
        NUSE, S_eff = geom_cuda.spt_layout(k, p.voxel_sample)
        A = p.rad_n * p.ele_n * p.azi_n
        KK = 2 * K
        winners = geom_cuda.spt_valid_winners(planes, R_all, draws[0].spt_prio,
                                              p.rad_n, p.azi_n, p.ele_n,
                                              p.delta / p.rad_n, p.voxel_sample)
        entry(geom_cuda.SPT, counts["spt_pooled"], spt_err,
              cuda_ms(lambda: geom_cuda.spt_pooled_cuda(*spt_args), 10),
              cuda_ms(lambda: geom_cuda.spt_pooled_plain(*spt_args), 2),
              KK * A * S_eff * 7 + winners * 16 * 8 + KK * S_eff * 20,
              KK * S_eff * 12 + KK * 36 + S_eff * 4 + KK * 16 * A * 4
              + A * 48 * 4, None,
              valid_winners=winners, slots=KK * A * NUSE,
              plan=geom_cuda.spt_plan(KK, S_eff, A, NUSE), ptxas=ptxas["spt_pooled"])

    # 5.-6. the banded kNN (both stages) and the banded 1-NN, every call of
    # the pair; the KITTI pair's calls checked, scored and timed (the plain
    # versions there too slow to time)
    from buffer_tpu_torch.kernels import knn_cuda
    sums, rows = banded_entries(calls, cfg)
    ksums, krows = banded_entries(kcalls, kcfg, time_plain=False)
    quality = {"3DMatch": {n: s["score"] for n, s in sums.items()},
               "KITTI": {n: s["score"] for n, s in ksums.items()}}
    print(json.dumps({"banded_quality": quality}))
    if (min(sums["bknn"]["score"]) <= RECALL_KNN
            or min(sums["bnn1"]["score"]) <= AGREE_NN1):
        raise RuntimeError(f"banded search below its bars on 3DMatch: {quality}")
    # the banded 1-NN's calls of a training step: the pyramid's l0 -> l1
    # and the positive-pair sampler's (B = 1), checked and timed
    train_tests, train_ms, train_launch_ms = 0, 0.0, 0.0
    for a in tbnn1_calls:
        got = knn_cuda.banded_nn1_cuda(*a)
        if not all(torch.equal(x, y) for x, y in
                   zip(got, knn_cuda.banded_nn1_plain(*a))):
            raise RuntimeError("bnn1 (training step): kernel and plain differ")
        train_tests += a[0].shape[0] * a[0].shape[1] * 16 * knn_cuda.NSEG
        train_ms += cuda_ms(lambda a=a: knn_cuda.banded_nn1_cuda(*a), 20)
        train_launch_ms += cuda_ms(knn_cuda.bnn1_launcher(
            *a, [torch.empty_like(x) for x in got]), 20)
    for kern, name in ((knn_cuda.BKNN, "bknn"), (knn_cuda.BNN1, "bnn1")):
        s = sums[name]
        extra = {} if name == "bknn" else {
            "launch_ms": s["launch_ms"], "launch_ms_kitti": ksums[name]["launch_ms"],
            "plan": [r["plan"] for r in rows if r["kernel"] == "bnn1"],
            "launches_train_step": train["stages"][0][
                "launches_last_step"].get("bnn1", 0),
            "ms_train": train_ms, "launch_ms_train": train_launch_ms,
            "calls_train": [[*a[0].shape[:2], a[1].shape[1]] for a in tbnn1_calls]}
        entry(kern, counts[name], 0.0, s["ms"], s["plain_ms"], s["flops"],
              s["bytes"], None, ms_kitti=ksums[name]["ms"],
              calls_kitti=ksums[name]["calls"], ptxas=ptxas[name], **extra)
        if name == "bknn":
            floor("bknn", BKNN_SLOTS, tests=s["tests"],
                  tests_kitti=ksums[name]["tests"])
        else:
            floor("bnn1", BNN1_SLOTS, tests=s["tests"],
                  tests_kitti=ksums[name]["tests"], tests_train=train_tests)
        reference[name] = {"exact_search_ms": s["exact_ms"], "calls": s["calls"],
                           "what": ("ops.neighbors.radius_knn with band=None"
                                    if name == "bknn" else
                                    "chunked torch.cdist + min"),
                           "note": "a different function: the exact search "
                                   "the banded kernel stands in for"}
    print(json.dumps({"exact_search_reference": reference}))

    # 7. single-cloud FPS: row 0 of the batched kernel and the plain version
    ib = fps_cuda.fps_cuda_batched(sds0[None], elig0[None], K)[0]
    ipl = fps_cuda.fps_single_plain(sds0, elig0, K)
    if not (torch.equal(fidx, ib) and torch.equal(fidx, ipl)):
        raise RuntimeError("fps_single: differs from the batched kernel or "
                           "the plain version")
    N1 = sds0.shape[0]
    single_ms = cuda_ms(lambda: sampling.farthest_point_sample(sds0, elig0, K), 5)
    entry(fps_cuda.FPS_SINGLE, fcounts["fps_single"], 0.0, single_ms,
          cuda_ms(lambda: fps_cuda.fps_single_plain(sds0, elig0, K), 1),
          (K - 1) * N1 * 9, N1 * 13 + K * 4, None,
          per_step_us=1e3 * single_ms / (K - 1))

    # 8. the training front's ball sampling: every call of one (eval) step;
    # and the fused_desc = False pair's call (checked and timed)
    def points_check(args):
        flops = nbytes = tests = 0
        for a in args:
            outk = geom_cuda.ball_sample_points_cuda(*a)
            outp = geom_cuda.ball_sample_points_plain(*a)
            if not all(torch.equal(x, y) for x, y in zip(outk, outp)):
                raise RuntimeError("ball_sample_points: kernel and plain differ "
                                   f"at {tuple(a[0].shape)} x {tuple(a[1].shape)}")
            q, sup, k = a[0], a[1], a[5]
            B, Q, N = q.shape[0], q.shape[1], sup.shape[1]
            tests += B * Q * N
            flops += B * Q * N * 7
            nbytes += B * (N * 17 + Q * 12 + Q * k * 13)
        return flops, nbytes, tests

    def points_ms(args, iters):
        return sum(cuda_ms(lambda a=a: geom_cuda.ball_sample_points_cuda(*a),
                           iters) for a in args)

    def points_launch_ms(args):
        return sum(ball_launch_ms(
            geom_cuda.BALL_POINTS, a,
            [torch.empty((*a[0].shape[:2], a[5], 3), device=dev),
             torch.empty(a[0].shape[:2] + (a[5],), dtype=torch.uint8,
                         device=dev)]) for a in args)

    points_plan = lambda args: [geom_cuda.ball_plan(
        a[0].shape[0], a[0].shape[1], a[1].shape[1] // (a[5] // 2), a[5] // 2)
        for a in args]
    sball_calls = scalls["ball_sample_points_cuda"]
    flops, nbytes, tests = points_check(ball_calls)
    *_, tests_sampled = points_check(sball_calls)
    entry(geom_cuda.BALL_POINTS, train["launches"]["ball_sample_points"], 0.0,
          points_ms(ball_calls, 10),
          sum(cuda_ms(lambda a=a: geom_cuda.ball_sample_points_plain(*a), 2)
              for a in ball_calls),
          flops, nbytes, None,
          launch_ms=points_launch_ms(ball_calls), plan=points_plan(ball_calls),
          ms_sampled=points_ms(sball_calls, 10),
          launch_ms_sampled=points_launch_ms(sball_calls),
          calls_sampled=[[*a[0].shape[:2], a[1].shape[1], a[5]]
                         for a in sball_calls],
          plan_sampled=points_plan(sball_calls),
          ptxas=ptxas["ball_sample_points"])
    floor("ball_sample_points", BALL_SLOTS, tests=tests,
          tests_sampled=tests_sampled)
    derived = {"sm_clock_mhz": clock / 1e6, "sms": SMS, "fp32_lanes": LANES,
               "kernels": floors}
    print(json.dumps({"issue_floor": derived}))

    return {"card": card_line(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas,
            "paths": [main_line, kitti_line, band0_line, sampled_line],
            "train": train["stages"], "train_launches": train["launches"],
            "plain_train_checks": train_checks,
            "ball_points_calls": [{"B": a[0].shape[0], "Q": a[0].shape[1],
                                   "N": a[1].shape[1], "k": a[5]}
                                  for a in ball_calls],
            "fps_single_launches": fcounts, "plain_path_checks": checks,
            "banded_calls": {"3DMatch": rows, "KITTI": krows},
            "banded_quality": quality, "exact_search_reference": reference,
            "kernels": kernels, "issue_floor": derived,
            "pose_gt": {"3DMatch": [T.tolist() for T in poses_gt],
                        "KITTI": [T.tolist() for T in kposes_gt]}}


if __name__ == "__main__":
    sys.exit(main())
