"""Quick quality sanity of one registration (counterpart of the
repository's ``scripts/sanity_pair.py``):

    python -m buffer_tpu_torch.scripts.sanity_pair [--torch-weights DIR]
        [--tiny --device cpu]

Registers the benchmark's 3DMatch pairs (bench.py's wavy surface, seeds 0,
1 and 2, each with draws from a generator seeded by its seed) through the
compiled program (``make_register_fn``) with a reference snapshot
(``--torch-weights``: ``<stage>/best.pth``, through
``compat.torch_convert``) or, without one, seeded random weights, and says
which.  Prints one JSON line: each pair's RTE (m), RRE (degrees), mutual
and RANSAC inlier counts.  Runs on the CUDA card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

SEEDS = (0, 1, 2)


def run(cfg, model, dev) -> list:
    """Each seed's pair registered by ``model`` on ``dev``: RTE, RRE and
    the counts."""
    from buffer_tpu_torch.data.synthetic import surface_pair
    from buffer_tpu_torch.eval.metrics import rte_rre
    from buffer_tpu_torch.pipeline.registration import make_draws, make_register_fn
    fn = make_register_fn(model, device=dev)
    out = []
    for seed in SEEDS:
        inputs, T = surface_pair(cfg, seed, dev)
        draws = make_draws(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        res = fn(inputs, draws)
        rte, rre = rte_rre(res.pose.cpu().double().numpy(), T)
        out.append({"seed": seed, "rte_m": rte, "rre_deg": rre,
                    "mutual": int(res.num_mutual),
                    "inliers": int(res.num_inliers)})
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m buffer_tpu_torch.scripts.sanity_pair")
    ap.add_argument("--torch-weights", default=None,
                    help="reference snapshot directory with <stage>/best.pth "
                         "(default: seeded random weights)")
    ap.add_argument("--tiny", action="store_true",
                    help="the miniature static plan of the tests")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.config import make_cfg, shrink_static
    from buffer_tpu_torch.scripts.profile_stages import bench_model

    dev = resolve_device(args.device)
    cfg = make_cfg("3DMatch")
    if args.tiny:
        cfg = shrink_static(cfg)
    model, weights = bench_model(cfg, args.torch_weights, dev)
    print(json.dumps({"config": "3DMatch", "device": str(dev),
                      "weights": weights, "pairs": run(cfg, model, dev)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
