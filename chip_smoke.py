#!/usr/bin/env python3
"""Smoke test of buffer_tpu_torch on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the four
   CUDA kernels from ``buffer_tpu_torch/csrc`` (one nvcc each, in parallel).
2. Drives the port's main path: ``register_pair`` on the 3DMatch preset with
   ``static.knn_band = 0`` (the exact unbanded neighbour search) at full
   width -- 30720/10240/3072 pyramid points, 65536 raw points, 1500
   keypoints, 512-point patches, 1024 RANSAC hypotheses with the x4
   low-match boost -- on synthetic fragment pairs (the surface generator of
   bench.py) with seeded random weights.  Every kernel launch counter is
   set to 0 just before and read just after; each kernel must have run on
   every pair.  Prints ms/pair and a per-stage breakdown (CUDA events).
3. Runs the first pair once more with the plain PyTorch versions of the
   kernels on the card (substituted at the kernels' call sites): keypoint
   indices and the mutual-match count must be equal, the descriptors within
   1e-3 and the pose within 1e-4.
4. Holds each kernel against its plain version on the main path's inputs
   (exact for 1-NN, FPS and ball sampling; 2e-5 for the SPT front), times
   kernel, plain version and, where one PyTorch call computes the same
   function, that call (CUDA events after warm-up), and computes each
   kernel's bound from this run's inputs.

Any failure exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it holds every kernel's
numbers.  Details go to ``chiprun_out/chip_smoke.json``.  Without a CUDA
device the script exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

PEAK_FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
N_PAIRS = 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


@contextlib.contextmanager
def plain_versions():
    """Within the block the four kernels' call sites call the plain PyTorch
    versions: the same registration on the card without the kernels."""
    from buffer_tpu_torch.kernels import fps_cuda, geom_cuda
    from buffer_tpu_torch.models import patch_embedder
    from buffer_tpu_torch.ops import neighbors, sampling
    sites = [(neighbors, "nearest_cuda", geom_cuda.nearest_plain),
             (neighbors, "ball_sample_planes_cuda",
              geom_cuda.ball_sample_planes_plain),
             (sampling, "fps_cuda_batched", fps_cuda.fps_plain),
             (patch_embedder, "spt_pooled_cuda", geom_cuda.spt_pooled_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    for mod, name, plain in sites:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def run_main_path(model, dev, pairs, draws, cuda, registration):
    """The main path: every count set to 0 just before, read just after."""
    import torch
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
        rose = {k: after[k] - before[k] for k in after}
        if min(rose.values()) <= 0:
            raise RuntimeError(f"a kernel did not run on this pair: {rose}")
        per_pair.append(ms)
        results.append(res)
        stages.append(timer.stage_ms())
    return cuda.launch_counts(), per_pair, results, stages


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from buffer_tpu_torch.config import threedmatch_cfg, unbanded
    print(card_line())
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    summary = run(torch.device("cuda", 0), unbanded(threedmatch_cfg()), N_PAIRS)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"kernels": summary["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev, cfg, n_pairs: int) -> dict:
    """Build, drive the main path, check it against the plain path and
    measure each kernel; returns the summary (raises on any failure)."""
    import torch
    from buffer_tpu_torch.data.synthetic import surface_pair
    from buffer_tpu_torch.kernels import cuda, fps_cuda, geom_cuda
    from buffer_tpu_torch.models import patch_embedder as pe
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.pipeline import registration

    t0 = time.time()
    logs = cuda.build_all()
    build_s = time.time() - t0
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln] for k, v in logs.items()}
    print(json.dumps({"build_s": build_s, "ptxas": ptxas}))

    p = cfg.patch
    model = BufferModel(cfg, seed=0).to(dev)
    t0 = time.time()
    pairs_T = [surface_pair(cfg, seed, dev) for seed in range(n_pairs)]
    prep_s = time.time() - t0
    pairs = [x[0] for x in pairs_T]
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = [registration.make_draws(cfg, gen, dev) for _ in pairs]
    print(json.dumps({"config": "3DMatch, knn_band=0", "pairs": n_pairs,
                      "host_prep_s": prep_s,
                      "valid_points": {f: [int(m.sum()) for m in getattr(pairs[0], f)]
                                       for f in ("raw_mask", "sds_mask",
                                                 "lvl1_mask", "lvl2_mask")}}))

    # ---- the main path --------------------------------------------------
    counts, per_pair, results, stages = run_main_path(
        model, dev, pairs, draws, cuda, registration)
    for r in results:
        if not torch.isfinite(r.pose).all():
            raise RuntimeError("non-finite pose")
        if r.pose.shape != (4, 4) or r.kpts.shape != (2, cfg.point.num_keypts, 3):
            raise RuntimeError("unexpected output shapes")
    n_kpts = [[int(v) for v in r.kpt_valid.sum(1)] for r in results]
    if min(min(n) for n in n_kpts) <= 0:
        raise RuntimeError(f"no eligible keypoints: {n_kpts}")
    warm = per_pair[1:] if len(per_pair) > 1 else per_pair
    stage_mean = {k: sum(s[k] for s in stages[1:] or stages) / len(stages[1:] or stages)
                  for k in stages[0]}
    slice_line = {
        "slice_ms_per_pair": sum(warm) / len(warm), "first_pair_ms": per_pair[0],
        "per_pair_ms": per_pair, "stage_ms": stage_mean,
        "eligible_keypoints": n_kpts,
        "num_mutual": [int(r.num_mutual) for r in results],
        "num_inliers": [int(r.num_inliers) for r in results],
        "launches": counts}
    print(json.dumps(slice_line))

    # ---- the same pair through the plain versions on the card -----------
    res_k, inter_k = registration.register_pair(
        model, pairs[0], draws[0], device=dev, return_intermediates=True)
    before = cuda.launch_counts()
    with plain_versions():
        res_p, inter_p = registration.register_pair(
            model, pairs[0], draws[0], device=dev, return_intermediates=True)
    if cuda.launch_counts() != before:
        raise RuntimeError("a kernel ran on the plain path")
    pose_err = float((res_k.pose - res_p.pose).abs().max())
    if not torch.equal(inter_k["kidx"], inter_p["kidx"]):
        raise RuntimeError("keypoint indices differ between kernels and plain")
    # unit descriptors: the SPT front may differ by 2e-5 before the CNN
    desc_err = max(float((inter_k[n] - inter_p[n]).abs().max())
                   for n in ("s_des", "t_des"))
    if (int(res_k.num_mutual) != int(res_p.num_mutual) or pose_err > 1e-4
            or desc_err > 1e-3):
        raise RuntimeError(f"kernel and plain paths disagree: mutual "
                           f"{int(res_k.num_mutual)} vs {int(res_p.num_mutual)}, "
                           f"pose {pose_err}, descriptors {desc_err}")
    print(json.dumps({"plain_path_check": {"kidx_equal": True,
                                           "num_mutual": int(res_k.num_mutual),
                                           "desc_max_abs_err": desc_err,
                                           "pose_max_abs_err": pose_err}}))

    # ---- each kernel against its plain version at the main-path inputs ---
    pyr = inter_k["pyramid"]
    kernels = []

    def entry(kern, launches, err, ms, plain_ms, flops, nbytes, lib_ms):
        b_ms, b_by = bound(flops, nbytes)
        e = {"name": kern.name, "route": "cuda", "source": kern.source,
             "replaces": kern.replaces, "launches": launches,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        print(json.dumps(e))
        kernels.append(e)

    # 1. exact 1-NN: both upsamples of one pair (l0 -> l1, l1 -> l2)
    nn_args = [(pyr.points[l], pyr.points[l + 1], pyr.masks[l + 1]) for l in (0, 1)]
    err = 0.0
    for a in nn_args:
        (dk, ik), (dp, ip) = geom_cuda.nearest_cuda(*a), geom_cuda.nearest_plain(*a)
        if not torch.equal(ik, ip):
            raise RuntimeError("nearest: kernel and plain indices differ")
        err = max(err, float((dk - dp).abs().max()))

    def cdist_nn(q, s, valid, chunk=4096):
        far = torch.where(valid[..., None], s, torch.full_like(s, 1e6))
        return [torch.cdist(q[:, i:i + chunk], far).min(dim=2)
                for i in range(0, q.shape[1], chunk)]

    nn_ms = sum(cuda_ms(lambda a=a: geom_cuda.nearest_cuda(*a), 20) for a in nn_args)
    nn_plain = sum(cuda_ms(lambda a=a: geom_cuda.nearest_plain(*a), 3) for a in nn_args)
    nn_lib = sum(cuda_ms(lambda a=a: cdist_nn(*a), 5) for a in nn_args)
    flops = sum(a[0].shape[0] * a[0].shape[1] * a[1].shape[1] * 8 for a in nn_args)
    nbytes = sum(a[0].numel() * 4 + a[1].numel() * 4 + a[2].numel()
                 + a[0].shape[0] * a[0].shape[1] * 8 for a in nn_args)
    entry(geom_cuda.NEAREST, counts["nearest"], err, nn_ms, nn_plain, flops,
          nbytes, nn_lib)

    # 2. batched FPS on the detector-eligible points
    sds = pairs[0].sds
    elig = pairs[0].sds_mask & (inter_k["score"] > cfg.point.keypts_th)
    K = cfg.point.num_keypts
    ik = fps_cuda.fps_cuda_batched(sds, elig, K)
    ip = fps_cuda.fps_plain(sds, elig, K)
    if not torch.equal(ik, ip):
        raise RuntimeError("fps: kernel and plain indices differ")
    B, N = elig.shape
    entry(fps_cuda.FPS, counts["fps"], float((ik - ip).abs().max()),
          cuda_ms(lambda: fps_cuda.fps_cuda_batched(sds, elig, K), 5),
          cuda_ms(lambda: fps_cuda.fps_plain(sds, elig, K), 1),
          B * (K - 1) * N * 9, B * N * 13 + B * K * 4, None)

    # 3. ball sampling of both clouds' patches
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
          Bq * Q * Nr * 7, Bq * (Nr * 17 + Q * 12 + Q * k * 13), None)

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
        _, S_eff = geom_cuda.spt_layout(k, p.voxel_sample)
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
              + A * 48 * 4, None)

    return {"card": card_line(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas,
            "slice": slice_line, "kernels": kernels,
            "pose_gt": [T.tolist() for _, T in pairs_T]}


if __name__ == "__main__":
    sys.exit(main())
