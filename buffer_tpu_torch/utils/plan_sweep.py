"""Kernel time of the banded kNN, ball sampling, the banded 1-NN and the
exact 1-NN over launch plans, on the card.

    python -m buffer_tpu_torch.utils.plan_sweep [--iters 20] [--recorded]

For every banded-kNN call shape of the shipped 3DMatch and KITTI pyramids
(two seeded Morton-sorted surface clouds, ~95% valid) it runs
``csrc/bknn.cu`` with :func:`~buffer_tpu_torch.kernels.knn_cuda.bknn_plan`'s
plan and with other ring depths; for ball sampling at the inference shape
(both clouds' 1500 keypoints, 512-point patches from 65536 and 131072 raw
points) and the training shape (512 keypoints) it runs ``csrc/ball.cu``
with :func:`~buffer_tpu_torch.kernels.geom_cuda.ball_plan`'s plan and the
alternatives (queries a thread, segments a block, ring chunks); for the
banded 1-NN at its three call shapes (3DMatch's and KITTI's l0 -> l1
upsample, the training sampler's 30720 x 30720 at B = 1) it runs
``csrc/bnn1.cu`` with :func:`~buffer_tpu_torch.kernels.knn_cuda.bnn1_plan`'s
plan and other queries a thread; for the
exact 1-NN at its calls (both presets' l1 -> l2 upsample, and 3DMatch's
l0 -> l1 at ``knn_band = 0``) it runs ``csrc/nearest.cu`` with
:func:`~buffer_tpu_torch.kernels.geom_cuda.nearest_plan`'s plan and other
queries a thread and cluster sizes.  The alternatives go straight to the
C launch (``knn_cuda.bknn_launcher``, ``geom_cuda.ball_launcher``,
``knn_cuda.bnn1_launcher``, ``geom_cuda.nearest_launcher``), never through
the wrappers.  Each plan is
first checked bit-equal to the plain version, then timed (CUDA events over
``--iters`` launches after a warm-up).  One JSON line a plan: the shape,
the plan, whether it is the default, ms.  It is the evidence behind the
plans' rules; the main path never calls it.

With ``--recorded`` it instead runs ``register_pair`` on the first synthetic
pair of each preset (the pairs of ``chip_smoke.py``) and the training
sampler's ``nearest_common_morton`` on that pair's source (moved by a
rigid motion) and target, records every call of the banded kNN, the banded
1-NN and the exact 1-NN and prints, for each, the wrapper's time (CUDA
events) and the device time of every kernel the call launches
(``torch.profiler``).  That mode uses no plan, so this file also runs it in
an earlier tree of the package (copied into that tree's
``buffer_tpu_torch/utils/`` and run there as a module), which is how the
kernels' per-call times before their redesigns were measured.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from buffer_tpu_torch.data.preprocess import morton_sort
from buffer_tpu_torch.kernels import cuda, geom_cuda, knn_cuda

# (name, Q, S, k, radius) of the banded calls at each preset
BKNN_CALLS = {
    "3DMatch": [("l0 kNN", 30720, 30720, 16, None),
                ("l1 kNN", 10240, 10240, 16, 0.14),
                ("pool 0", 10240, 30720, 16, 0.14),
                ("pool 1", 3072, 10240, 16, 0.28)],
    "KITTI": [("l0 kNN", 40960, 40960, 16, None),
              ("l1 kNN", 20480, 20480, 16, 1.2),
              ("l2 kNN", 6144, 6144, 16, 2.4),
              ("pool 0", 20480, 40960, 16, 1.2),
              ("pool 1", 6144, 20480, 16, 2.4)],
}
BKNN_RINGS = [2, 3, 6, 8]
# (name, B, Q, N, k, radius)
BALL_CALLS = [("3DMatch planes", 2, 1500, 65536, 512, 0.3),
              ("KITTI planes", 2, 1500, 131072, 512, 3.0),
              ("3DMatch points", 2, 512, 65536, 512, 0.3)]
# (queries a thread, segments a block, ring chunks)
BALL_ALTERNATIVES = [(8, 32, 2), (8, 32, 4), (4, 32, 3), (8, 64, 3),
                     (4, 64, 3), (8, 128, 3), (8, 256, 3)]
# (name, B, Q, S, extent) of the banded 1-NN calls
BNN1_CALLS = [("3DMatch l0 -> l1", 2, 30720, 10240, 1.5),
              ("KITTI l0 -> l1", 2, 40960, 20480, 40.0),
              ("3DMatch sampler", 1, 30720, 30720, 1.5)]
# queries a thread
BNN1_ALTERNATIVES = [4, 8, 16]
# (name, B, Q, S, extent) of the exact 1-NN calls
NEAREST_CALLS = [("3DMatch l1 -> l2", 2, 10240, 3072, 1.5),
                 ("KITTI l1 -> l2", 2, 20480, 6144, 40.0),
                 ("3DMatch knn_band=0 l0 -> l1", 2, 30720, 10240, 1.5)]
# (queries a thread, CTAs a cluster)
NEAREST_ALTERNATIVES = [(q, c) for q in (1, 2, 4, 8) for c in (1, 2, 4, 8)]


def bknn_variant(ring: int):
    """A ``csrc/bknn.cu`` plan with ``ring`` chunks in flight."""
    return (knn_cuda.BKNN_THREADS, ring, knn_cuda.bknn_smem_bytes(ring))


def ball_variant(NS: int, queries: int, segments: int, ring: int):
    """A ``csrc/ball.cu`` plan of ``queries`` a thread and slices of
    ``segments`` (fewer, in whole warps, when NS is smaller), built by
    :func:`~buffer_tpu_torch.kernels.geom_cuda.ball_plan`'s rules."""
    NSB = min(segments, -(-NS // 32) * 32)
    CH = max(4, geom_cuda.BALL_CHUNK_POINTS // NSB // 4 * 4)
    return (queries, geom_cuda.BALL_THREADS // NSB, NSB, CH, ring,
            geom_cuda.ball_smem_bytes(NSB, CH, ring))


def poisoned(want):
    """Outputs shaped as ``want`` that hold no right answer (NaN, -1, the
    negated mask), so a launch that writes nothing fails the check."""
    return [torch.logical_not(t) if t.dtype == torch.bool
            else torch.full_like(t, float("nan") if t.is_floating_point() else -1)
            for t in want]


def cuda_ms(fn, iters: int) -> float:
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


def surface(rs, B: int, n: int, extent: float, dev):
    """B Morton-sorted wavy surfaces of n points, ~5% invalid (a run and
    scattered points)."""
    pts = np.zeros((B, n, 3), np.float32)
    for b in range(B):
        c = rs.uniform(-extent, extent, (n, 3)).astype(np.float32)
        c[:, 2] = 0.1 * extent * np.sin(3 * c[:, 0] / extent)
        pts[b] = morton_sort(c)
    valid = rs.rand(B, n) > 0.03
    valid[:, n // 3:n // 3 + n // 50] = False
    return torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev)


def sweep_bknn(dev, iters: int) -> None:
    rs = np.random.RandomState(0)
    extent = {"3DMatch": 1.5, "KITTI": 40.0}
    for preset, calls in BKNN_CALLS.items():
        for name, Q, S, k, radius in calls:
            sup, sv = surface(rs, 2, S, extent[preset], dev)
            if Q == S:
                qry, qv = sup, sv
            else:
                qry, qv = surface(rs, 2, Q, extent[preset], dev)
            args = (qry, sup, sv, qv, k, radius)
            want = knn_cuda.banded_knn_plain(*args)
            _, LW = knn_cuda.window_rows(S, knn_cuda.KNN_WIN_ROWS)
            default = knn_cuda.bknn_plan(2, Q, S, LW)
            plans = [default] + [bknn_variant(r) for r in BKNN_RINGS]
            for plan in dict.fromkeys(plans):
                got = poisoned(want)
                outs = got[:-1] + [got[-1].view(torch.uint8)]
                launch = knn_cuda.bknn_launcher(*args, knn_cuda.KNN_WIN_ROWS,
                                                outs, plan)
                launch()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise RuntimeError(f"bknn {preset} {name} {plan}: kernel "
                                       "and plain differ")
                print(json.dumps({"kernel": "bknn", "preset": preset,
                                  "call": name, "Q": Q, "S": S, "plan": plan,
                                  "default": plan == default,
                                  "ms": cuda_ms(launch, iters)}))


def sweep_ball(dev, iters: int) -> None:
    rs = np.random.RandomState(1)
    for name, B, Q, N, k, radius in BALL_CALLS:
        sup, valid = surface(rs, B, N, 1.5 if radius < 1 else 40.0, dev)
        q = sup[:, torch.from_numpy(rs.choice(N, Q, replace=False)).to(dev)]
        prio = torch.rand((B, N), device=dev)
        args = (q, sup, valid, prio, radius, k)
        points = "points" in name
        kern = geom_cuda.BALL_POINTS if points else geom_cuda.BALL
        plain = (geom_cuda.ball_sample_points_plain if points
                 else geom_cuda.ball_sample_planes_plain)
        want = plain(*args)
        L, NS = N // (k // 2), k // 2
        default = geom_cuda.ball_plan(B, Q, L, NS)
        plans = [default] + [ball_variant(NS, qt, nsb, r)
                             for qt, nsb, r in BALL_ALTERNATIVES]
        for plan in dict.fromkeys(plans):
            got = poisoned(want)
            outs = got[:-1] + [got[-1].view(torch.uint8)]
            launch = geom_cuda.ball_launcher(kern, *args, outs, plan)
            launch()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"ball {name} {plan}: kernel and plain "
                                   "differ")
            print(json.dumps({"kernel": "ball", "call": name, "Q": Q, "N": N,
                              "plan": plan, "default": plan == default,
                              "valid_share": float(want[-1].float().mean()),
                              "ms": cuda_ms(launch, iters)}))


def sweep_bnn1(dev, iters: int) -> None:
    rs = np.random.RandomState(2)
    for name, B, Q, S, extent in BNN1_CALLS:
        sup, sv = surface(rs, B, S, extent, dev)
        qry, qv = surface(rs, B, Q, extent, dev)
        args = (qry, sup, sv, qv)
        want = knn_cuda.banded_nn1_plain(*args)
        default = knn_cuda.bnn1_plan(B, Q, S)
        for plan in dict.fromkeys([default] + BNN1_ALTERNATIVES):
            got = poisoned(want)
            launch = knn_cuda.bnn1_launcher(*args, got, plan)
            launch()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"bnn1 {name} {plan}: kernel and plain differ")
            print(json.dumps({"kernel": "bnn1", "call": name, "B": B, "Q": Q,
                              "S": S, "plan": plan, "default": plan == default,
                              "ms": cuda_ms(launch, iters)}))


def sweep_nearest(dev, iters: int) -> None:
    rs = np.random.RandomState(3)
    for name, B, Q, S, extent in NEAREST_CALLS:
        sup, sv = surface(rs, B, S, extent, dev)
        qry, _ = surface(rs, B, Q, extent, dev)
        args = (qry, sup, sv)
        want = geom_cuda.nearest_plain(*args)
        default = geom_cuda.nearest_plan(B, Q, S)
        for plan in dict.fromkeys([default] + NEAREST_ALTERNATIVES):
            if -(-S // plan[1]) > geom_cuda.NEAREST_MAX_SLICE:
                continue
            got = poisoned(want)
            launch = geom_cuda.nearest_launcher(*args, got, plan)
            launch()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"nearest {name} {plan}: kernel and plain "
                                   "differ")
            print(json.dumps({"kernel": "nearest", "call": name, "B": B,
                              "Q": Q, "S": S, "plan": plan,
                              "default": plan == default,
                              "ms": cuda_ms(launch, iters)}))


def recorded_calls(dev, iters: int) -> None:
    """Each neighbour-kernel call of the first pair of each preset and of
    the training sampler on it, timed."""
    from torch.profiler import ProfilerActivity, profile

    from buffer_tpu_torch.config import kitti_cfg, threedmatch_cfg
    from buffer_tpu_torch.data.synthetic import lidar_pair, surface_pair
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.ops import neighbors
    from buffer_tpu_torch.pipeline import registration
    gen = torch.Generator(device=dev).manual_seed(0)
    names = {"banded_knn_cuda": ("bknn", "bknn_kernel"),
             "banded_nn1_cuda": ("bnn1", "bnn1_kernel"),
             "nearest_cuda": ("nearest", "nearest_kernel")}
    for preset, cfg, make, seed in (
            ("3DMatch", threedmatch_cfg(), surface_pair, 0),
            ("KITTI", kitti_cfg(), lidar_pair, 13)):
        inputs = make(cfg, seed, dev)[0]
        draws = registration.make_draws(cfg, gen, dev)
        calls, saved = [], {n: getattr(neighbors, n) for n in names}

        def recorder(name):
            return lambda *a: calls.append((name, "pair", a)) or saved[name](*a)

        for n in names:
            setattr(neighbors, n, recorder(n))
        try:
            registration.register_pair(BufferModel(cfg, seed=0).to(dev), inputs,
                                       draws, device=dev)
            if preset == "3DMatch":
                # the positive-pair sampler of a training step: the source
                # moved by a rigid motion against the target, B = 1
                c, s_ = np.cos(0.3), np.sin(0.3)
                R = torch.tensor([[c, -s_, 0], [s_, c, 0], [0, 0, 1]],
                                 dtype=torch.float32, device=dev)
                src = inputs.sds[0] @ R.T + 0.05
                n0 = len(calls)
                neighbors.nearest_common_morton(
                    src, inputs.sds_mask[0], inputs.sds[1], inputs.sds_mask[1],
                    cfg.static.knn_band)
                calls[n0:] = [(n, "sampler", a) for n, _, a in calls[n0:]]
        finally:
            for n, fn in saved.items():
                setattr(neighbors, n, fn)
        for name, where, a in calls:
            fn = saved[name]
            kernel, search = names[name]
            ms = cuda_ms(lambda: fn(*a), iters)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn(*a)
                torch.cuda.synchronize()
            device_us = {e.key: e.self_device_time_total / iters
                         for e in prof.key_averages()
                         if e.self_device_time_total > 0}
            print(json.dumps({
                "kernel": kernel, "preset": preset, "call": where,
                "B": a[0].shape[0], "Q": a[0].shape[1], "S": a[1].shape[1],
                "ms": ms, "device_us": sum(device_us.values()),
                "search_kernel_us": sum(v for k, v in device_us.items()
                                        if search in k),
                "device_ops_us": device_us}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--recorded", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("plan_sweep: no CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    if args.recorded:
        cuda.build_all()
        recorded_calls(dev, args.iters)
        return 0
    logs = cuda.build_all()
    for name in ("bknn", "ball_sample", "ball_sample_points", "bnn1", "nearest"):
        print(json.dumps({"ptxas": name, "lines": [
            ln.strip() for ln in logs[name].splitlines()
            if "registers" in ln or "spill" in ln]}))
    for sweep in (sweep_bknn, sweep_ball, sweep_bnn1, sweep_nearest):
        sweep(dev, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
