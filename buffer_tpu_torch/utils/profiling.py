"""Device-time profile of one full-width registration, or one training
step, on the card.

    python -m buffer_tpu_torch.utils.profiling [--config {3DMatch,KITTI}]
        [--knn-band N] [--device-levels] [--pairs N] [--out DIR]
        [--train-stage {Ref,Desc,Keypt,Inlier} [--program]]

Runs ``register_pair`` (the preset at full width with its own
``knn_band`` unless ``--knn-band`` says otherwise, seeded random weights;
3DMatch on :func:`~buffer_tpu_torch.data.synthetic.bench_pair`, KITTI on
:func:`~buffer_tpu_torch.data.synthetic.lidar_pair` seed 13, bench.py's
pairs; with ``--device-levels`` without its host-built pyramid levels,
so that the pyramid voxel-subsamples them on the card) once to warm up,
then ``--pairs`` more without and ``--pairs`` more under
``torch.profiler``.  Prints one JSON line: the wall time per pair without
and with the profiler, the device time summed over CUDA kernels (busy
share = device time / wall time without the profiler), the kernel launch
count, per stage of ``register_pair`` its span on the device timeline
(CUDA events, without the profiler) beside the kernel time between its
boundary markers in the profile, and the operators with the most device
time.  The Chrome trace goes to ``DIR/profile_<config>_band<N>.json.gz``
(``..._levels.json.gz`` with device levels).

With ``--train-stage`` it profiles ``train/trainer.train_step`` of that
stage on the first pair with its ground-truth pose (one warm-up step, then
``--pairs`` steps without and with the profiler, the same draws each
step): wall and device ms per step, busy share, launches and the top
operators; the trace goes to ``DIR/profile_train_<stage>.json.gz``.  With
``--program`` the step is ``make_train_step``'s compiled one (the warm-up
is its first call and capture; the steps are graph replays), so that the
replay's host and device time read side by side with the eager step's;
its trace goes to ``DIR/profile_train_<stage>_program.json.gz``.

The helpers of the measurement entry points (``scripts/profile_*.py``,
``scripts/capture_*trace.py``), counterparts of
``buffer_tpu/utils/profiling.py`` and of the JAX scripts' on-device scan
timing: :func:`trace`, :func:`annotate`, :class:`StepTimer`,
:func:`graph_time` and :func:`replay_time`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import math
import os
import shutil
import subprocess
import time
from typing import Iterator, Optional

# torch.profiler keeps only the device records that it dates inside its
# capture window: on the card the first kernels of a call launched as the
# window opened went missing now and then (up to ~15 ms of them), so the
# profiled work starts, and the window closes, this long after the card
# is idle
SETTLE_S = 0.25
# ...and it lost the first device records of a window whole, the same
# ones in every profile of a process (a training step's input copies and
# first kernel, seen on the card): a window opens with this many spin
# kernels, which take that loss and which kernel_events leaves out
WARMUP_KERNELS = 4
SPIN_KERNEL = "spin_kernel"


def settle() -> None:
    """Waits for the card to finish, then :data:`SETTLE_S` seconds."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    time.sleep(SETTLE_S)


def open_window() -> None:
    """The start of a profiled window: :data:`WARMUP_KERNELS` spin kernels
    on the card (none without one), then :func:`settle`."""
    import torch
    if torch.cuda.is_available():
        for _ in range(WARMUP_KERNELS):
            torch.cuda._sleep(1000)
    settle()


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """A ``torch.profiler`` trace of the block's CPU activity and, where a
    card is present, its CUDA activity, written into ``log_dir`` as a
    gzipped Chrome trace ``<ns>.trace.json.gz``; yields that path.  Nothing
    (and None) when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{time.time_ns()}.trace.json")
    with profile(activities=activities) as prof:
        open_window()
        yield path + ".gz"
        settle()
    save_trace(prof, path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named span: a ``torch.profiler`` record function and, where a card
    is present, an NVTX range."""
    import torch
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class StepTimer:
    """Host-clock step timer that synchronizes the card (where one is
    present) before and after each measure, so that a step's time includes
    its device work; keeps every time and their median (seconds)."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self):
        import torch
        sync = (torch.cuda.synchronize if torch.cuda.is_available()
                else lambda: None)
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        self.times.append(time.perf_counter() - t0)

    @property
    def median(self) -> float:
        s = sorted(self.times)
        return s[len(s) // 2] if s else float("nan")


def replay_time(call, n_lo: int = 2, n_hi: int = 12, reps: int = 3) -> float:
    """Device milliseconds of one ``call()`` by differencing: ``n_lo``, then
    ``n_hi`` calls back to back between two CUDA events, ``reps`` times
    each; (min at n_hi - min at n_lo) / (n_hi - n_lo).  The fixed costs of
    a run (the first launch's latency, the events) cancel."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("replay_time: no CUDA device")

    def best(n: int) -> float:
        ms = math.inf
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                call()
            end.record()
            end.synchronize()
            ms = min(ms, start.elapsed_time(end))
        return ms

    torch.cuda.synchronize()
    lo = best(n_lo)
    return (best(n_hi) - lo) / (n_hi - n_lo)


def graph_time(body, n_lo: int = 2, n_hi: int = 12, reps: int = 3) -> float:
    """Device milliseconds of ``body`` (a closure over fixed input tensors
    that returns tensors), the counterpart of the JAX scripts' scan
    differencing: ``body`` runs once eagerly on a side stream (first-use
    allocations and caches), is captured once as a CUDA graph, and the
    graph's replays are timed by :func:`replay_time`.  Each replay adds the
    launches of the kernels it holds to their counters.  Raises without a
    card."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("graph_time: no CUDA device")
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.pipeline.registration import capture_graph
    stream = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        body()
    stream.wait_stream(side)
    graph, out, launches = capture_graph(body, torch.cuda.graph_pool_handle())

    def replay():
        graph.replay()
        cuda.add_launches(launches)

    ms = replay_time(replay, n_lo, n_hi, reps)
    del out
    return ms


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class StageMarks:
    """A ``register_pair`` timer that launches a marker kernel (ATen's
    ``spin_kernel``, which the pipeline never launches) at each stage
    boundary, so the profile's kernels split into stages by their order on
    the stream."""

    MARKER = "spin_kernel"

    def mark(self) -> None:
        import torch
        torch.cuda._sleep(0)


def stage_device_ms(kernels, stages, pairs: int):
    """Kernel time per stage per pair from the profile's kernel events:
    the stream's kernels between consecutive markers belong to one stage."""
    out = {s: 0.0 for s in stages}
    kernels = sorted(kernels, key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(kernels) if StageMarks.MARKER in e.name]
    if len(marks) != pairs * (len(stages) + 1):
        raise RuntimeError(f"expected {pairs * (len(stages) + 1)} stage "
                           f"markers, found {len(marks)}")
    for p in range(pairs):
        m = marks[p * (len(stages) + 1):(p + 1) * (len(stages) + 1)]
        for s, a, b in zip(stages, m, m[1:]):
            out[s] += sum(e.time_range.elapsed_us()
                          for e in kernels[a + 1:b]) / 1e3 / pairs
    return out


def kernel_events(prof):
    """The device events of a profile, the window's spin kernels left
    out."""
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and SPIN_KERNEL not in e.name]


def top_ops(prof, n: int):
    top = sorted(prof.key_averages(), key=lambda a: -a.self_device_time_total)[:15]
    return [{"name": a.key[:120], "device_ms_per_call":
             a.self_device_time_total / 1e3 / n, "calls_per_call": a.count / n}
            for a in top]


def save_trace(prof, path: str) -> None:
    prof.export_chrome_trace(path)
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)


def profile_train(args, cfg, model, inputs, T, dev) -> int:
    """``--train-stage``: the profile of one stage's training step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.train.trainer import (TrainBatch, make_optimizer,
                                                make_train_step, train_step)
    stage, n = args.train_stage, args.pairs
    opt, _ = make_optimizer(cfg, model, stage)
    batch = TrainBatch(inputs, torch.as_tensor(T, device=dev))
    draws = make_train_draws(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    margin = 1.0 if cfg.data.dataset == "KITTI" else 1.05
    if args.program:
        fn = make_train_step(model, opt, stage, margin, dev)
        step = lambda: fn(batch, draws)
    else:
        step = lambda: train_step(model, opt, stage, batch, draws, margin, dev)
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        open_window()
        for _ in range(n):
            step()
        settle()
    kernels = kernel_events(prof)
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    os.makedirs(args.out, exist_ok=True)
    suffix = "_program" if args.program else ""
    save_trace(prof, os.path.join(args.out,
                                  f"profile_train_{stage}{suffix}.json"))
    print(json.dumps({
        "config": args.config, "train_stage": stage, "program": args.program,
        "steps": n,
        "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "kernel_launches_per_step": len(kernels) / n,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "top_ops": top_ops(prof, n)}))
    return 0


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from buffer_tpu_torch.config import make_cfg
    from buffer_tpu_torch.data.synthetic import bench_pair, lidar_pair
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.pipeline.registration import (StageTimer, make_draws,
                                                        register_pair)

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=("3DMatch", "KITTI"), default="3DMatch")
    ap.add_argument("--knn-band", type=int, default=None,
                    help="static.knn_band (default: the preset's)")
    ap.add_argument("--device-levels", action="store_true",
                    help="drop the host-built pyramid levels")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--train-stage", choices=("Ref", "Desc", "Keypt", "Inlier"),
                    default=None, help="profile this stage's training step")
    ap.add_argument("--program", action="store_true",
                    help="with --train-stage: the compiled step's replays")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device")
    dev = torch.device("cuda", 0)
    cuda.build_all()
    cfg = make_cfg(args.config)
    if args.knn_band is not None:
        cfg = cfg.replace(static=dataclasses.replace(cfg.static,
                                                     knn_band=args.knn_band))
    model = BufferModel(cfg, seed=0).to(dev)
    if args.config == "KITTI":
        inputs, T = lidar_pair(cfg, 13, dev)
    else:
        inputs, T = bench_pair(cfg, dev)
    if args.device_levels:
        inputs = inputs._replace(lvl1=None, lvl1_mask=None, lvl2=None,
                                 lvl2_mask=None)
    if args.train_stage:
        return profile_train(args, cfg, model, inputs, T, dev)
    draws = make_draws(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    register_pair(model, inputs, draws, device=dev)
    torch.cuda.synchronize()
    span = {s: 0.0 for s in StageTimer.STAGES}
    t0 = time.perf_counter()
    for _ in range(args.pairs):
        timer = StageTimer()
        register_pair(model, inputs, draws, device=dev, timer=timer)
        for s, ms in timer.stage_ms().items():
            span[s] += ms / args.pairs
    torch.cuda.synchronize()
    plain_wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        open_window()
        t0 = time.perf_counter()
        for _ in range(args.pairs):
            register_pair(model, inputs, draws, device=dev, timer=StageMarks())
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        settle()
    kernels = kernel_events(prof)
    busy = stage_device_ms(kernels, StageTimer.STAGES, args.pairs)
    kernels = [e for e in kernels if StageMarks.MARKER not in e.name]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    stages = {s: {"span_ms": span[s], "device_ms": busy[s],
                  "busy_share": busy[s] / span[s] if span[s] else None}
              for s in StageTimer.STAGES}
    os.makedirs(args.out, exist_ok=True)
    levels = "_levels" if args.device_levels else ""
    save_trace(prof, os.path.join(
        args.out, f"profile_{args.config}_band{cfg.static.knn_band}{levels}.json"))
    print(json.dumps({
        "config": args.config, "knn_band": cfg.static.knn_band,
        "device_levels": args.device_levels,
        "pairs": args.pairs, "wall_ms_per_pair": plain_wall_ms / args.pairs,
        "profiled_wall_ms_per_pair": wall_ms / args.pairs,
        "device_ms_per_pair": device_ms / args.pairs,
        "device_busy_share": device_ms / plain_wall_ms,
        "kernel_launches_per_pair": len(kernels) / args.pairs,
        "stages": stages, "top_ops": top_ops(prof, args.pairs)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
