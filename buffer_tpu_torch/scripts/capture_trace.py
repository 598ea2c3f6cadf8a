"""A device trace of the compiled registration program's replays
(counterpart of the repository's ``scripts/capture_trace.py``):

    python -m buffer_tpu_torch.scripts.capture_trace [--config {3DMatch,KITTI}]
        [--torch-weights DIR] [--iters 4] [--out DIR]

On the pair, weights and draws of ``profile_stages``, ``make_register_fn``
is called twice (warm-up and capture, then a replay), then ``--iters``
replays run inside :func:`~buffer_tpu_torch.utils.profiling.trace` and
under one ``annotate("replays")``, the card synchronized inside the span.
Prints one JSON line with the trace's path; read it with
``python -m buffer_tpu_torch.scripts.analyze_trace <path> --iters N``.
Runs on the CUDA card only.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch


def traced_replays(call, iters: int, out: str) -> str:
    """``call()`` ``iters`` times inside a trace written into ``out`` and
    one ``replays`` span, the card idle before the span and synchronized
    inside it; returns the trace's path."""
    from buffer_tpu_torch.utils.profiling import annotate, trace
    torch.cuda.synchronize()
    with trace(out) as path:
        with annotate("replays"):
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
    return path


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m buffer_tpu_torch.scripts.capture_trace")
    ap.add_argument("--config", default="3DMatch", choices=("3DMatch", "KITTI"))
    ap.add_argument("--torch-weights", default=None,
                    help="reference snapshot directory with <stage>/best.pth "
                         "(default: seeded random weights)")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--out", default=None,
                    help="trace directory (default: build/torchtrace/ at "
                         "the repository root)")
    args = ap.parse_args(argv)

    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.config import make_cfg
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.pipeline.registration import make_register_fn
    from buffer_tpu_torch.scripts.profile_stages import (bench_model,
                                                         profile_pair)
    from buffer_tpu_torch.utils.profiling import card_line

    dev = resolve_device(None)
    cuda.build_all()
    cfg = make_cfg(args.config)
    model, weights = bench_model(cfg, args.torch_weights, dev)
    inputs, _, draws = profile_pair(cfg, dev)
    fn = make_register_fn(model, device=dev)
    for _ in range(2):
        fn(inputs, draws)
    path = traced_replays(lambda: fn(inputs, draws), args.iters,
                          args.out or str(cuda.BUILD_DIR / "torchtrace"))
    print(json.dumps({"card": card_line(), "config": args.config,
                      "weights": weights, "iters": args.iters, "trace": path}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
