"""Throughput of data-parallel registration by world size (counterpart of
the repository's ``scripts/dp_scaling.py``): ``make_dp_register``'s pairs/s
(all ranks' pairs over the host clock of a run of timed rounds, after
warm-up rounds) at each world size given, each a fresh launch of ranks
(``utils/dist.launch``).  On the card the pair is the 3DMatch preset's at
full width (``data/synthetic.surface_pair``, seeded random weights); with
``--device cpu`` the tiny plan.  Ranks beyond the card count share cards,
which NCCL refuses, so the backend defaults to gloo::

    python -m buffer_tpu_torch.utils.dp_scaling --worlds 1 2 \\
        --json dp_scaling.json
    python -m buffer_tpu_torch.utils.dp_scaling --device cpu --worlds 1 2
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

import torch


def measure(cfg, state: Dict[str, torch.Tensor], pairs: list, draws: list,
            world: int, backend: str, device=None, iters: int = 6,
            warmup: int = 2, timeout: float = 600.0,
            threads: Optional[int] = None) -> List[dict]:
    """One launch of ``utils/dp_jobs.register_job`` at ``world`` ranks over
    ``pairs`` (CPU ``PairInputs``) with ``draws`` (CPU ``Draws``), then
    ``warmup`` + ``iters`` timed rounds; returns each rank's record."""
    from buffer_tpu_torch.utils.dist import launch
    cpu = lambda nt: type(nt)(*(None if t is None else t.cpu() for t in nt))
    payload = {"cfg": cfg, "state": {k: v.cpu() for k, v in state.items()},
               "pairs": [cpu(p) for p in pairs],
               "draws": [cpu(d) for d in draws],
               "device": None if device is None else str(device),
               "iters": iters, "warmup": warmup}
    return launch("buffer_tpu_torch.utils.dp_jobs:register_job", payload,
                  world, backend=backend, device=device, timeout=timeout,
                  threads=threads)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m buffer_tpu_torch.utils.dp_scaling")
    ap.add_argument("--worlds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the tiny plan on the CPU (default: the "
                         "cards)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.config import threedmatch_cfg, tiny_cfg
    from buffer_tpu_torch.data.synthetic import surface_pair
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.pipeline.registration import make_draws

    dev = resolve_device(args.device)
    cfg = tiny_cfg() if dev.type == "cpu" else threedmatch_cfg()
    state = BufferModel(cfg, seed=0).state_dict()
    pair, _ = surface_pair(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    points = []
    for world in args.worlds:
        pairs = [pair] * world
        draws = [make_draws(cfg, gen, "cpu") for _ in pairs]
        # CPU ranks share the host's cores: one thread each
        ranks = measure(cfg, state, pairs, draws, world, args.backend,
                        args.device, args.iters, args.warmup,
                        threads=1 if dev.type == "cpu" else None)
        rec = {"world": world, "pairs_per_s": ranks[0]["pairs_per_s"]}
        points.append(rec)
        print(f"world={world}: {rec['pairs_per_s']:.3f} pairs/s", flush=True)
    for rec in points:
        rec["speedup"] = rec["pairs_per_s"] / points[0]["pairs_per_s"]
    out = {"metric": "dp_register_pairs_per_s",
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "config": "tiny" if dev.type == "cpu" else "3DMatch",
           "backend": args.backend, "iters": args.iters, "points": points}
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
