"""Synthetic robustness evaluation (counterpart of the repository's
``scripts/synthetic_eval.py``): many varied fragment pairs through the
whole registration pipeline, recall per bucket under the reference's own
pose thresholds (0.3 m / 15 degrees for 3DMatch, ThreeDMatch/test.py:264-270;
0.3 m / 1 degree for KITTI, KITTI/test.py:66-67).

Buckets:
* 3DMatch, overlap in [0.45, 0.95] (seed 7): the primary gate;
* 3DMatch, overlap in [0.25, 0.45] (seed 11): the 3DLoMatch-like regime;
* KITTI LiDAR scenes (seed 13): ground, facades, poles and cars, 9-13 m
  apart, SO(2)-dominant motion.

Each pair's generated ground truth is first checked by host ICP
(:func:`~buffer_tpu_torch.data.synthetic.icp_check_gt`), per pair loosely
and by the bucket's median matched residual tightly, so that a generator
fault raises instead of reading as a model failure.

    python -m buffer_tpu_torch.scripts.synthetic_eval --config 3DMatch \\
        --pairs 100 --torch-weights <reference snapshot dir> --json QUALITY.json
    python -m buffer_tpu_torch.scripts.synthetic_eval --config KITTI \\
        --tiny --device cpu --pairs 2 --weights <dir of <stage>/best.pth>

Weights come from ``--torch-weights`` (a reference snapshot directory;
default: the reference repository's snapshot of the configuration under
``--reference-root``) or ``--weights`` (this package's per-stage
checkpoints); a missing file raises.  Runs on the CUDA card unless
``--device cpu`` is given.  ``main`` returns the exit code: 1 when an
``--assert-*`` recall is not met.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

# reference snapshots of the published weights, under the reference
# repository's root
SNAPS = {
    "3DMatch": os.path.join("ThreeDMatch", "snapshot", "06132318"),
    "KITTI": os.path.join("KITTI", "snapshot", "06050001"),
}


def run_bucket(model, cfg, pair_gen: Callable, n_pairs: int, seed: int,
               rte_th: float, rre_th: float, label: str, gt_check=None,
               per_pair: Optional[list] = None,
               draws_fn: Optional[Callable] = None, device=None,
               register_fn: Optional[Callable] = None):
    """Registers ``n_pairs`` pairs of ``pair_gen(cfg, rs, i) -> (inputs, T,
    desc)`` drawing from ``RandomState(seed)``, pair i with
    ``draws_fn(i)`` (default: a generator seeded with i, as the JAX script
    keys pair i with ``PRNGKey(i)``), through ``register_fn`` (default: a
    :func:`~buffer_tpu_torch.pipeline.registration.make_register_fn`
    program of the model), and returns (recall, pairs).

    ``gt_check`` = (max_dist, rte_tol, rre_tol, med_tol) cross-checks each
    pair's ground truth by host ICP before it is registered: a correction
    beyond rte_tol / rre_tol raises, and so does a bucket median of the
    pairs' median matched residuals beyond med_tol (a generator fault is
    systematic; per-pair corrections alias on smooth surfaces).  Prints a
    line a pair; appends a record a pair to ``per_pair``."""
    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.data.synthetic import icp_check_gt
    from buffer_tpu_torch.eval.metrics import rte_rre
    from buffer_tpu_torch.pipeline import registration

    dev = resolve_device(device)
    if register_fn is None:
        register_fn = registration.make_register_fn(model, device=dev)
    rs = np.random.RandomState(seed)
    states, gt_meds = [], []
    for i in range(n_pairs):
        inputs, T, desc = pair_gen(cfg, rs, i)
        if gt_check is not None:
            max_dist, rte_tol, rre_tol, _ = gt_check
            g_rte, g_rre, g_frac, g_med = icp_check_gt(inputs, T, max_dist)
            gt_meds.append(g_med)
            if g_rte > rte_tol or g_rre > rre_tol:
                raise RuntimeError(
                    f"[{label}] pair {i}: synthetic GT fails the ICP "
                    f"cross-check (correction RTE={g_rte:.4f} m "
                    f"RRE={g_rre:.3f} deg, match_frac={g_frac:.3f} vs tol "
                    f"{rte_tol}/{rre_tol}) -- generator GT bug, not a "
                    f"model failure")
        draws = (draws_fn(i) if draws_fn is not None else
                 registration.make_draws(
                     cfg, torch.Generator(device=dev).manual_seed(i), dev))
        res = register_fn(inputs, draws)
        rte, rre = rte_rre(res.pose.cpu().numpy().astype(np.float64),
                           np.asarray(T, np.float64))
        ok = rte < rte_th and rre < rre_th
        states.append(ok)
        if per_pair is not None:
            per_pair.append({"bucket": label, "pair": i, "desc": desc,
                             "ok": bool(ok), "rte": round(rte, 4),
                             "rre": round(rre, 3),
                             "mutual": int(res.num_mutual)})
        print(f"[{label}] pair {i:3d} {desc} mutual={int(res.num_mutual):4d} "
              f"RTE={rte:.4f} RRE={rre:.3f} {'OK' if ok else 'FAIL'}",
              flush=True)
    if gt_meds:
        bucket_med = float(np.median(gt_meds))
        med_tol = gt_check[3]
        print(f"[{label}] GT cross-check: bucket median residual "
              f"{bucket_med*1000:.1f} mm (tol {med_tol*1000:.0f} mm)",
              flush=True)
        if bucket_med > med_tol:
            raise RuntimeError(
                f"[{label}] synthetic GT fails the bucket-level ICP "
                f"cross-check (median matched residual {bucket_med:.4f} m "
                f"> tol {med_tol} m) -- systematic generator GT bug, not "
                f"a model failure")
    recall = float(np.mean(states)) if states else float("nan")
    print(f"[{label}] recall: {recall:.3f} over {len(states)} pairs",
          flush=True)
    return recall, len(states)


def room_gen(lo: float, hi: float):
    """A 3DMatch-like room pair with overlap in [lo, hi], noise in
    [0, 1 cm] and clutter in [0, 0.1]: at 12% or more uniform volumetric
    clutter the reference's descriptors stop discriminating on these
    smooth synthetic surfaces (out of the model's distribution), so the
    gate samples clutter where the pipeline is expected to succeed."""
    from buffer_tpu_torch.data.synthetic import make_room_pair

    def gen(cfg, rs, i):
        overlap = rs.uniform(lo, hi)
        noise = rs.uniform(0.0, 0.01)
        clutter = rs.uniform(0.0, 0.1)
        inputs, T = make_room_pair(cfg, rs, overlap, noise, clutter,
                                   device="cpu")
        return inputs, T, (f"overlap={overlap:.2f} noise={noise:.3f} "
                           f"clutter={clutter:.2f}")
    return gen


def kitti_gen(cfg, rs, i):
    """A KITTI-like LiDAR pair 9-13 m apart with 0.5-2 cm noise."""
    from buffer_tpu_torch.data.synthetic import make_lidar_pair
    dist = rs.uniform(9.0, 13.0)
    noise = rs.uniform(0.005, 0.02)
    inputs, T = make_lidar_pair(cfg, rs, dist=dist, noise=noise, device="cpu")
    return inputs, T, f"dist={dist:.1f} noise={noise:.3f}"


# GT cross-check tolerances (max_dist, per-pair rte / rre, bucket-median
# residual), from the JAX script's measured bands: rooms 12-20 mm median
# residual (45 mm worst, low overlap), >= 56 mm at a doubled translation;
# LiDAR ~165-170 mm, >= 270 mm doubled
GT_CHECK = {"3DMatch": (0.10, 0.05, 1.0, 0.040),
            "KITTI": (1.0, 0.30, 1.0, 0.220)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m buffer_tpu_torch.scripts.synthetic_eval")
    ap.add_argument("--pairs", type=int, default=20,
                    help="pairs in the primary bucket")
    ap.add_argument("--low-pairs", type=int, default=None,
                    help="pairs in the 3DMatch low-overlap bucket "
                         "(default: pairs)")
    ap.add_argument("--config", default="3DMatch",
                    choices=["3DMatch", "KITTI"])
    ap.add_argument("--json", default=None,
                    help="also append a one-line JSON record to this path")
    ap.add_argument("--assert-recall", type=float, default=None,
                    help="exit 1 unless the primary bucket's recall >= this")
    ap.add_argument("--assert-low-recall", type=float, default=None,
                    help="exit 1 unless the low-overlap bucket's recall "
                         ">= this")
    ap.add_argument("--refine-iters", type=int, default=None,
                    help="override static.refine_iters (IRLS rounds)")
    ap.add_argument("--hypotheses", type=int, default=None,
                    help="override match.hypotheses (batched RANSAC)")
    ap.add_argument("--no-check-gt", action="store_true",
                    help="skip the host-ICP cross-check of the generated "
                         "ground truth (on by default)")
    ap.add_argument("--exact", action="store_true",
                    help="the exact stack: unbanded neighbour search "
                         "(knn_band=0), the reference's sampled descriptor "
                         "front (fused_desc=False), refine_iters=20, "
                         "hypotheses=4096")
    ap.add_argument("--buckets", default="all", choices=["all", "low", "high"],
                    help="3DMatch: which overlap buckets to run")
    ap.add_argument("--per-pair-json", default=None,
                    help="write one JSON line a pair (scenes depend on the "
                         "seeds only, so runs with equal pair counts pair up)")
    ap.add_argument("--torch-weights", default=None,
                    help="reference snapshot directory with <stage>/best.pth "
                         "(default: the configuration's snapshot under "
                         "--reference-root)")
    ap.add_argument("--reference-root", default="reference",
                    help="root of the reference repository")
    ap.add_argument("--weights", default=None,
                    help="directory of this package's <stage>/best.pth")
    ap.add_argument("--tiny", action="store_true",
                    help="the miniature static plan of the tests")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.config import make_cfg, shrink_static
    from buffer_tpu_torch.pipeline import registration
    from buffer_tpu_torch.scripts.test import load_model

    if args.exact:
        if args.refine_iters is None:
            args.refine_iters = 20
        if args.hypotheses is None:
            args.hypotheses = 4096
    dev = resolve_device(args.device)
    cfg = make_cfg(args.config)
    if args.tiny:
        cfg = shrink_static(cfg)
    static, match = cfg.static, cfg.match
    if args.refine_iters is not None:
        static = dataclasses.replace(static, refine_iters=args.refine_iters)
    if args.exact:
        static = dataclasses.replace(static, knn_band=0, fused_desc=False)
    if args.hypotheses is not None:
        match = dataclasses.replace(match, hypotheses=args.hypotheses)
    cfg = cfg.replace(static=static, match=match)
    torch_weights = args.torch_weights
    if not (args.weights or torch_weights):
        torch_weights = os.path.join(args.reference_root, SNAPS[args.config])
    model = load_model(cfg, args.weights, torch_weights, dev)

    gt_check = None if args.no_check_gt else GT_CHECK[args.config]
    per_pair = [] if args.per_pair_json else None
    register_fn = registration.make_register_fn(model, device=dev)
    run = lambda gen, n, seed, rre_th, label: run_bucket(
        model, cfg, gen, n, seed, 0.3, rre_th, label, gt_check=gt_check,
        per_pair=per_pair, device=dev, register_fn=register_fn)
    buckets = {}
    if args.config == "3DMatch":
        r_hi = r_lo = None
        n_hi = n_lo = 0
        if args.buckets in ("all", "high"):
            # seed 7: the primary bucket's scene stream of the JAX script
            r_hi, n_hi = run(room_gen(0.45, 0.95), args.pairs, 7, 15.0,
                             "overlap_045_095")
            buckets["overlap_045_095"] = {"recall": round(r_hi, 4),
                                          "pairs": n_hi}
        if args.buckets in ("all", "low"):
            n_low = args.low_pairs if args.low_pairs is not None else args.pairs
            r_lo, n_lo = run(room_gen(0.25, 0.45), n_low, 11, 15.0,
                             "overlap_025_045")
            buckets["overlap_025_045"] = {"recall": round(r_lo, 4),
                                          "pairs": n_lo}
        primary, low = (r_hi if r_hi is not None else r_lo), r_lo
        unit = "recall@0.3m/15deg"
        n_primary = n_hi if r_hi is not None else n_lo
    else:
        primary, n_primary = run(kitti_gen, args.pairs, 13, 1.0, "kitti")
        buckets = {"kitti": {"recall": round(primary, 4), "pairs": n_primary}}
        low = None
        unit = "recall@0.3m/1deg"

    print(f"\nsynthetic recall ({args.config}): {primary:.3f} "
          f"over {n_primary} pairs")
    if args.per_pair_json and per_pair:
        with open(args.per_pair_json, "w") as f:
            for rec in per_pair:
                f.write(json.dumps(rec) + "\n")
    if args.json:
        # one line a configuration's run: QUALITY.json is their
        # concatenation, so every field describes the run that wrote it
        rec = {"metric": "synthetic_recall", "value": round(primary, 4),
               "unit": unit, "pairs": n_primary, "config": args.config,
               "buckets": buckets}
        if args.exact or args.refine_iters is not None \
                or args.hypotheses is not None:
            rec["settings"] = {"exact": args.exact,
                               "refine_iters": cfg.static.refine_iters,
                               "hypotheses": cfg.match.hypotheses,
                               "knn_band": cfg.static.knn_band,
                               "fused_desc": cfg.static.fused_desc}
        with open(args.json, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec))
    rc = 0
    if args.assert_recall is not None and primary < args.assert_recall:
        print(f"FAIL: recall {primary:.3f} < {args.assert_recall}")
        rc = 1
    if (args.assert_low_recall is not None and low is not None
            and low < args.assert_low_recall):
        print(f"FAIL: low-overlap recall {low:.3f} < {args.assert_low_recall}")
        rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
