"""Diagnose the KITTI synthetic-pair failure mode (counterpart of the
repository's ``scripts/diag_kitti.py``): for each mutual match of one
synthetic LiDAR pair, test its consistency with the ground-truth pose and
with the sensor-centric alias pose (the rotation alone: translation 0
between the sensor frames).

    python -m buffer_tpu_torch.scripts.diag_kitti \\
        --torch-weights <reference KITTI snapshot dir>
    python -m buffer_tpu_torch.scripts.diag_kitti \\
        --weights <dir of <stage>/best.pth> [--tiny --device cpu]

The pair is :func:`~buffer_tpu_torch.data.synthetic.make_lidar_pair` of
the KITTI preset from ``RandomState(13)``, registered through the compiled
program (``make_register_fn`` with its intermediates) with draws from a
generator seeded 0.  Weights come from ``--torch-weights`` (a reference
snapshot directory; default: the KITTI snapshot under
``--reference-root``) or ``--weights`` (this package's per-stage
checkpoints); a missing file raises.  Runs on the CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

THRESHOLDS = (0.3, 0.6, 2.0)     # metres
SPLIT_TH = 0.6                   # where the radius and height lines split


def diagnose(pose, kpts, mutual, tgt_idx, T_gt) -> Dict:
    """The script's figures from host arrays: the registered pose [4, 4],
    keypoints [2, K, 3], the mutual mask [K] and each source keypoint's
    target index [K], against the ground truth T_gt [4, 4]."""
    kpts, mutual = np.asarray(kpts), np.asarray(mutual, bool)
    ss = kpts[0][mutual]
    tt = kpts[1][np.asarray(tgt_idx)][mutual]
    R, t = T_gt[:3, :3], T_gt[:3, 3]
    d_true = np.linalg.norm(ss @ R.T + t - tt, axis=-1)
    d_alias = np.linalg.norm(ss @ R.T - tt, axis=-1)
    r_s = np.linalg.norm(ss[:, :2], axis=-1)
    al, tr = d_alias < SPLIT_TH, d_true < SPLIT_TH
    return {
        "mutual": int(mutual.sum()), "pose_t": np.asarray(pose)[:3, 3],
        "gt_t": t,
        "consistent": [(th, int(np.sum(d_true < th)), int(np.sum(d_alias < th)))
                       for th in THRESHOLDS],
        "alias_radius": (np.median(r_s[al]), np.percentile(r_s[al], 10),
                         np.percentile(r_s[al], 90)) if al.sum() else None,
        "true_radius": np.median(r_s[tr]) if tr.sum() else None,
        "alias_z": np.median(ss[al][:, 2]) if al.sum() else None,
        "true_z": np.median(ss[tr][:, 2]) if tr.sum() else None}


def report(d: Dict) -> List[str]:
    """The lines the JAX script prints for :func:`diagnose`'s figures."""
    lines = [f"mutual={d['mutual']}  pose_t={d['pose_t']}  gt_t={d['gt_t']}"]
    lines += [f"th={th}: true-consistent={n_true:4d}  "
              f"alias-consistent={n_alias:4d}"
              for th, n_true, n_alias in d["consistent"]]
    a = d["alias_radius"]
    lines.append(f"alias match radius: median={a[0]:.1f} p10={a[1]:.1f} "
                 f"p90={a[2]:.1f}" if a is not None else "no alias matches")
    lines.append(f"true  match radius: median={d['true_radius']:.1f}"
                 if d["true_radius"] is not None else "no true matches")
    lines.append(f"alias match z: median={d['alias_z']:.2f}"
                 if d["alias_z"] is not None else "")
    lines.append(f"true  match z: median={d['true_z']:.2f}"
                 if d["true_z"] is not None else "")
    return lines


def run(model, cfg, draws=None, device=None) -> Dict:
    """Registers the script's pair with ``model`` (on ``device``) and
    returns :func:`diagnose`'s figures; ``draws`` default to a generator
    seeded 0."""
    import torch
    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.data.synthetic import make_lidar_pair
    from buffer_tpu_torch.pipeline import registration
    dev = resolve_device(device)
    inputs, T_gt = make_lidar_pair(cfg, np.random.RandomState(13), device=dev)
    if draws is None:
        draws = registration.make_draws(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
    res, inter = registration.make_register_fn(
        model, device=dev, return_intermediates=True)(inputs, draws)
    m = inter["matches"]
    return diagnose(res.pose.cpu().numpy(), inter["kpts"].cpu().numpy(),
                    m.mutual.cpu().numpy(), m.tgt_idx.long().cpu().numpy(),
                    T_gt)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m buffer_tpu_torch.scripts.diag_kitti")
    ap.add_argument("--torch-weights", default=None,
                    help="reference snapshot directory with <stage>/best.pth "
                         "(default: the KITTI snapshot under --reference-root)")
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
    from buffer_tpu_torch.scripts.synthetic_eval import SNAPS
    from buffer_tpu_torch.scripts.test import load_model

    dev = resolve_device(args.device)
    cfg = make_cfg("KITTI")
    if args.tiny:
        cfg = shrink_static(cfg)
    torch_weights = args.torch_weights
    if not (args.weights or torch_weights):
        torch_weights = os.path.join(args.reference_root, SNAPS["KITTI"])
    model = load_model(cfg, args.weights, torch_weights, dev).eval()
    for line in report(run(model, cfg, device=dev)):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
