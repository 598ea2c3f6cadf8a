"""Device-time profile of one full-width registration, or one training
step, on the card.

    python -m buffer_tpu_torch.utils.profiling [--config {3DMatch,KITTI}]
        [--knn-band N] [--device-levels] [--pairs N] [--out DIR]
        [--train-stage {Ref,Desc,Keypt,Inlier}]

Runs ``register_pair`` (the preset at full width with its own
``knn_band`` unless ``--knn-band`` says otherwise, seeded random weights;
3DMatch on :func:`~buffer_tpu_torch.data.synthetic.surface_pair`, KITTI on
:func:`~buffer_tpu_torch.data.synthetic.lidar_pair`; with
``--device-levels`` without its host-built pyramid levels, so that the
pyramid voxel-subsamples them on the card) once to warm up,
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
operators; the trace goes to ``DIR/profile_train_<stage>.json.gz``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import shutil
import time


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
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


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
                                                train_step)
    stage, n = args.train_stage, args.pairs
    opt, _ = make_optimizer(cfg, model, stage)
    batch = TrainBatch(inputs, torch.as_tensor(T, device=dev))
    draws = make_train_draws(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    margin = 1.0 if cfg.data.dataset == "KITTI" else 1.05
    step = lambda: train_step(model, opt, stage, batch, draws, margin, dev)
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = kernel_events(prof)
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    os.makedirs(args.out, exist_ok=True)
    save_trace(prof, os.path.join(args.out, f"profile_train_{stage}.json"))
    print(json.dumps({
        "config": args.config, "train_stage": stage, "steps": n,
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
    from buffer_tpu_torch.data.synthetic import lidar_pair, surface_pair
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
        inputs, T = surface_pair(cfg, 0, dev)
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
        t0 = time.perf_counter()
        for _ in range(args.pairs):
            register_pair(model, inputs, draws, device=dev, timer=StageMarks())
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
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
