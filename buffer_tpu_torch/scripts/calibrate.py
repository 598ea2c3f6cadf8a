"""Offline neighbour-cap calibration (counterpart of the repository's
``scripts/calibrate.py``).

The reference sizes its ragged neighbour lists when a loader is built, by
histogramming neighbour counts over ~2000 samples and keeping the 80th
percentile of each pyramid level (``ThreeDMatch/dataloader.py:18-51``).
With static shapes that calibration moves offline: this prints the
suggested ``StaticConfig`` caps (``neighbor_caps``, ``pool_caps``) and
padded sizes (``points_l*``, the raw cloud) for a dataset's test split.
It runs on the host (``data/host.py``'s native bindings):

    python -m buffer_tpu_torch.scripts.calibrate --config 3DMatch \\
        --data-root data/ThreeDMatch
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Parses ``argv`` (default: the command line) and prints the
    suggestions; returns them: for each neighbour table its cap and the
    largest count seen, for each cloud its largest size and the power of
    two that pads it."""
    from buffer_tpu_torch.config import PRESETS

    ap = argparse.ArgumentParser(
        prog="python -m buffer_tpu_torch.scripts.calibrate")
    ap.add_argument("--config", default="3DMatch", choices=list(PRESETS))
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--samples", type=int, default=50)
    ap.add_argument("--keep-ratio", type=float, default=0.8)
    args = ap.parse_args(argv)

    from buffer_tpu_torch.config import make_cfg
    from buffer_tpu_torch.data.host import (radius_neighbors_host,
                                            voxel_subsample_host)
    from buffer_tpu_torch.scripts.test import make_dataset

    cfg = make_cfg(args.config)
    if args.data_root:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                   root=args.data_root))
    ds = make_dataset(cfg)

    r0 = cfg.data.voxel_size_0 * cfg.point.conv_radius
    hist_cap = 256
    counts = {f"neighbors_l{l}": [] for l in range(3)}
    counts.update({f"pools_l{l}": [] for l in range(2)})
    sizes = {f"points_l{l}": [] for l in range(3)}
    sizes["raw"] = []

    n = min(len(ds), args.samples)
    for i in range(n):
        item = ds[i]
        for cloud in (item["src_fds_pts"], item["tgt_fds_pts"]):
            sizes["raw"].append(len(cloud))
            levels = [voxel_subsample_host(cloud, cfg.data.voxel_size_0)]
            for l in range(2):
                levels.append(voxel_subsample_host(
                    levels[-1], (2 ** (l + 1)) * cfg.data.voxel_size_0))
            for l, pts in enumerate(levels):
                sizes[f"points_l{l}"].append(len(pts))
                r = r0 * (2 ** l)
                _, c = radius_neighbors_host(pts, pts, r, hist_cap)
                counts[f"neighbors_l{l}"].extend(c.tolist())
                if l < 2:
                    _, c = radius_neighbors_host(levels[l + 1], pts, r,
                                                 hist_cap)
                    counts[f"pools_l{l}"].extend(c.tolist())
        print(f"[{i + 1}/{n}] done", flush=True)

    print("\nSuggested StaticConfig values "
          f"(keep_ratio={args.keep_ratio}, like the reference's 80th pctile):")
    out: Dict[str, dict] = {}
    for k, v in counts.items():
        pct = int(np.percentile(v, args.keep_ratio * 100))
        out[k] = {"cap": pct, "max": max(v)}
        print(f"  {k}: cap {pct} (max observed {max(v)})")
    for k, v in sizes.items():
        mx = max(v)
        pad = 1 << int(np.ceil(np.log2(mx)))
        out[k] = {"max": mx, "pad": pad}
        print(f"  {k}: max {mx} -> pad {pad}")
    return out


if __name__ == "__main__":
    main()
