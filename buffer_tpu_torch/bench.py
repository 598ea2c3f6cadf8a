"""Benchmark of the port: fragment-pair registrations per second on one
NVIDIA card (counterpart of the repository's ``bench.py``):

    python -m buffer_tpu_torch.bench [--size full|small]
        [--config 3DMatch|KITTI] [--iters N] [--batch P] [--unroll U]
        [--caps N] [--normal-knn N] [--l1 N] [--l2 N] [--torch-weights DIR]
        [--device D]

The measured call is the compiled registration program of P x U pairs
(``pipeline.registration.make_unrolled_register_fn``) as a user calls it:
each pair's input load and front graph on its own stream, side by side, the
one host read of the mutual counts, and each pair's tail graph that its
count selects.  P and U default as in bench.py:141-143: P is the preset's
``static.pair_batch`` (1), and U its ``static.pair_unroll`` when P is 1
(3DMatch and the tiny plan 3, KITTI 1), else 1.  bench.py vmaps P pairs;
a vmap of ``register_pair`` gives each pair what the pair alone gives, so
``--batch P`` runs the same unrolled program over P x U pairs.  The pair
is bench.py's: ``data.synthetic.bench_pair`` for 3DMatch, ``lidar_pair(
cfg, 13)`` for KITTI, at the preset's full static plan (``--size small``:
the tiny test plan, as bench.py), in every slot of a call, each slot with
draws of its own (a replay of graphs has none of XLA's hoisting or CSE,
so bench.py's input jog has no counterpart).  The weights are a reference
snapshot (``--torch-weights``, ``<stage>/best.pth``) or else seeded random
ones; the line says which.

Timing follows bench.py:193-213: after the first call (eager warm-up and
graph capture, reported as ``compile_s``), runs of ``n_lo = 2`` and
``n_hi = 2 + iters`` calls back to back, the host clock around each run
with the card synchronized at both ends, the least of 3 runs of each
length, and ``ms_per_pair = (t_hi - t_lo) / (n_hi - n_lo) / (P x U)``.

Prints exactly one JSON line with bench.py's keys (``vs_a100_est`` left
out: it scales by a guessed A100-over-RTX factor, not a measurement; the
sanity pose is the last call's first pair, as bench.py's) and, in
``extra``, the kernel build seconds, the capture seconds, device ms a pair
(CUDA events over an ``n_hi`` run), the timed pairs and those of them that
took the low-match tail, the launches a pair, the weights and the card's
name and power limit.  Runs on the CUDA card unless ``--device cpu`` is
given (then the program is the eager ``register_pair`` and the card's
fields are null).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

BASELINE_PAIRS_PER_SEC = 4.0  # 0.25 s/pair, the paper's GPU time (BASELINE.md)
N_LO = 2
REPS = 3


def differenced_ms(run: Callable[[int], None], n_lo: int, n_hi: int,
                   reps: int, clock: Callable[[], float] = time.perf_counter
                   ) -> float:
    """Milliseconds of one call: ``run(n)`` (n calls back to back) timed by
    ``clock`` (seconds), ``reps`` times at ``n_lo`` then at ``n_hi``; the
    least of each length differenced over ``n_hi - n_lo``, so a run's fixed
    costs cancel."""
    def least(n: int) -> float:
        best = math.inf
        for _ in range(reps):
            t0 = clock()
            run(n)
            best = min(best, clock() - t0)
        return best

    t_lo = least(n_lo)
    return 1e3 * (least(n_hi) - t_lo) / (n_hi - n_lo)


def bench_cfg(args):
    """The preset (``--size full``) or the tiny plan, with bench.py's
    static-plan overrides (bench.py:97-111)."""
    from buffer_tpu_torch.config import make_cfg, tiny_cfg
    cfg = make_cfg(args.config) if args.size == "full" else tiny_cfg()
    kw = {}
    if args.caps is not None:
        kw["neighbor_caps"] = (args.caps,) * 3
        kw["pool_caps"] = (args.caps,) * 2
    if args.normal_knn is not None:
        kw["normal_knn"] = args.normal_knn
    if args.l1 is not None:
        kw["points_l1"] = args.l1
    if args.l2 is not None:
        kw["points_l2"] = args.l2
    if kw:
        cfg = cfg.replace(static=dataclasses.replace(cfg.static, **kw))
    return cfg


def pairs_per_call(cfg, args):
    """(P, U): bench.py:141-143's pairs a call, batched and unrolled."""
    P = args.batch or cfg.static.pair_batch
    U = args.unroll or (cfg.static.pair_unroll if P == 1 else 1)
    return P, U


def sanity(pose: np.ndarray, T: np.ndarray):
    """bench.py's (RTE m, RRE degrees) of ``pose`` against ``T``."""
    rte = float(np.linalg.norm(pose[:3, 3] - T[:3, 3]))
    rre = float(np.degrees(np.arccos(np.clip(
        (np.trace(pose[:3, :3].T @ T[:3, :3]) - 1) / 2, -1, 1))))
    return rte, rre


def measure(cfg, model, inputs, draws, dev, per_call: int = 1) -> dict:
    """The unrolled program of ``per_call`` pairs, each ``inputs``: its first
    call, then the differenced runs over ``draws`` (``per_call`` a call,
    pair after pair; ``len(draws) // per_call`` calls the long run), then
    one more long run between CUDA events (on the card).  Returns the
    numbers a pair and ``results``, the long run's last results, a pair
    each."""
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.pipeline import registration
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    fn = registration.make_unrolled_register_fn(model, per_call, device=dev)
    groups = [draws[k:k + per_call]
              for k in range(0, len(draws) - per_call + 1, per_call)]
    results, calls = [], [0]

    def run(n: int) -> None:
        sync()
        results[:] = [fn([inputs] * per_call, g) for g in groups[:n]]
        sync()
        calls[0] += n

    n_hi = len(groups)
    with registration.full_fp32():
        t0 = time.perf_counter()
        fn([inputs] * per_call, groups[0])
        sync()
        compile_s = time.perf_counter() - t0
        ms = differenced_ms(run, N_LO, n_hi, REPS) / per_call
        device_ms = launches = capture_s = None
        if on_card:
            (program,) = fn.programs.values()
            capture_s = program.capture_s
            before = cuda.launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            sync()
            start.record()
            run(n_hi)
            end.record()
            end.synchronize()
            device_ms = start.elapsed_time(end) / (n_hi * per_call)
            launches = {k: (n - before[k]) / (n_hi * per_call)
                        for k, n in cuda.launch_counts().items()
                        if n != before[k]}
    if not ms > 0:
        raise RuntimeError(f"differenced time {ms} ms a pair is not positive: "
                           "the runs' noise exceeds their work; raise --iters")
    pairs = [type(r)(*(t[u] for t in r)) for r in results
             for u in range(per_call)]
    return {"ms_per_pair": ms, "compile_s": compile_s, "capture_s": capture_s,
            "device_ms_per_pair": device_ms, "launches_per_pair": launches,
            "calls": 1 + calls[0], "results": pairs}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m buffer_tpu_torch.bench")
    ap.add_argument("--size", default="full", choices=["full", "small"])
    ap.add_argument("--config", default="3DMatch", choices=["3DMatch", "KITTI"],
                    help="static plan / weights / scene family to bench")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=None,
                    help="pairs a call (bench.py's vmap; here the same "
                         "unrolled program); default: static.pair_batch")
    ap.add_argument("--unroll", type=int, default=None,
                    help="independent pairs a call, their chains side by "
                         "side; default: static.pair_unroll when the "
                         "batch is 1")
    ap.add_argument("--caps", type=int, default=None,
                    help="override neighbor/pool caps (all levels)")
    ap.add_argument("--normal-knn", type=int, default=None)
    ap.add_argument("--l1", type=int, default=None,
                    help="override static.points_l1")
    ap.add_argument("--l2", type=int, default=None,
                    help="override static.points_l2")
    ap.add_argument("--torch-weights", default=None,
                    help="reference snapshot directory with <stage>/best.pth "
                         "(default: seeded random weights)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    for flag in ("iters", "batch", "unroll"):
        if getattr(args, flag) is not None and getattr(args, flag) < 1:
            ap.error(f"--{flag} must be at least 1")

    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.data.synthetic import bench_pair, lidar_pair
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.pipeline import registration
    from buffer_tpu_torch.scripts.profile_stages import bench_model
    from buffer_tpu_torch.utils.profiling import card_line

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    build_s = None
    if on_card:
        t0 = time.perf_counter()
        cuda.build_all()
        build_s = time.perf_counter() - t0

    cfg = bench_cfg(args)
    # a snapshot that fails to load raises
    model, _ = bench_model(cfg, args.torch_weights, dev)
    if args.config == "KITTI":
        inputs, T = lidar_pair(cfg, 13, dev)
    else:
        inputs, T = bench_pair(cfg, dev)
    P, U = pairs_per_call(cfg, args)
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = [registration.make_draws(cfg, gen, dev)
             for _ in range((N_LO + args.iters) * P * U)]

    m = measure(cfg, model, inputs, draws, dev, P * U)
    last = m["results"][-P * U]
    rte, rre = sanity(last.pose.cpu().numpy(), T)
    value = 1e3 / m["ms_per_pair"]
    print(json.dumps({
        "metric": ("kitti_pairs_per_sec_single_chip" if args.config == "KITTI"
                   else "3dmatch_pairs_per_sec_single_chip"),
        "value": round(value, 3),
        "unit": "pairs/s",
        "vs_baseline": round(value / BASELINE_PAIRS_PER_SEC, 3),
        "extra": {
            "ms_per_pair": round(m["ms_per_pair"], 2),
            "compile_s": round(m["compile_s"], 1),
            "sanity_rte_m": round(rte, 4),
            "sanity_rre_deg": round(rre, 3),
            "mutual_matches": int(last.num_mutual),
            "platform": "gpu" if on_card else "cpu",
            "size": args.size,
            "config": args.config,
            "pair_batch": P,
            "pair_unroll": U,
            "build_s": build_s,
            "capture_s": m["capture_s"],
            "device_ms_per_pair": m["device_ms_per_pair"],
            "timed_pairs": len(m["results"]),
            "boost_pairs": sum(registration.boost_taken(cfg, r.num_mutual)
                               for r in m["results"]),
            "launches_per_pair": m["launches_per_pair"],
            "calls": m["calls"],
            "weights": "reference" if args.torch_weights else "random",
            "card": card_line() if on_card else None,
        },
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
