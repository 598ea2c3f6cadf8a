"""A device trace of one training stage's compiled step replays
(counterpart of the repository's ``scripts/capture_train_trace.py``):

    python -m buffer_tpu_torch.scripts.capture_train_trace [--stage Desc]
        [--iters 4] [--out DIR]

At the full 3DMatch plan, on the benchmark pair with its ground-truth pose,
seeded random weights and draws (as ``profile_train``): the stage's
``make_train_step`` is called twice (the eager step and capture, then a
replay), then ``--iters`` replays run inside a trace and one
``annotate("replays")`` span.  Prints one JSON line with the trace's path;
read it with ``python -m buffer_tpu_torch.scripts.analyze_trace <path>
--iters N``.  Runs on the CUDA card only.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from buffer_tpu_torch.scripts.capture_trace import traced_replays
from buffer_tpu_torch.scripts.profile_train import DET_MARGIN


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m buffer_tpu_torch.scripts.capture_train_trace")
    ap.add_argument("--stage", default="Desc",
                    choices=("Ref", "Desc", "Keypt", "Inlier"))
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--out", default=None,
                    help="trace directory (default: build/torchtrace/ at "
                         "the repository root)")
    args = ap.parse_args(argv)

    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.config import make_cfg
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.scripts.profile_stages import bench_pair
    from buffer_tpu_torch.train.trainer import (TrainBatch, make_optimizer,
                                                make_train_step)
    from buffer_tpu_torch.utils.profiling import card_line

    dev = resolve_device(None)
    cuda.build_all()
    cfg = make_cfg("3DMatch")
    model = BufferModel(cfg, seed=0).to(dev)
    opt, _ = make_optimizer(cfg, model, args.stage)
    fn = make_train_step(model, opt, args.stage, DET_MARGIN, dev)
    inputs, T, _ = bench_pair(cfg, dev)
    batch = TrainBatch(inputs, torch.as_tensor(T, device=dev))
    draws = make_train_draws(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    for _ in range(2):
        fn(batch, draws)
    path = traced_replays(lambda: fn(batch, draws), args.iters,
                          args.out or str(cuda.BUILD_DIR / "torchtrace"))
    print(json.dumps({"card": card_line(), "config": "3DMatch",
                      "stage": args.stage, "iters": args.iters, "trace": path}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
