"""Evaluation entry point (counterpart of the repository's ``scripts/test.py``;
reference ``ThreeDMatch/test.py``, ``KITTI/test.py``,
``generalization/*/test.py``; all seven configurations are presets):

    python -m buffer_tpu_torch.scripts.test --config 3DMatch \\
        --data-root data/ThreeDMatch --torch-weights <snapshot dir>
    python -m buffer_tpu_torch.scripts.test --config KITTI \\
        --data-root data/KITTI --weights <dir of Ref/ Desc/ Keypt/ Inlier/>

``--torch-weights`` takes a reference snapshot directory
(``<stage>/best.pth`` holding the whole composite state dict);
``--weights`` per-stage checkpoints: the JAX trainer's
(``<stage>/best.msgpack``, the layout of the repository's scripts) where
that file exists, else this package's own (``<stage>/best.pth`` written by
``train.checkpoint``).  Runs on the CUDA card unless ``--device cpu`` is
given.

Started by ``torchrun`` (``WORLD_SIZE`` > 1), every rank joins the process
group and ``run_eval`` registers the pairs one a rank (data parallelism
over pairs), each rank on card ``LOCAL_RANK % device_count``:

    torchrun --nproc_per_node 8 -m buffer_tpu_torch.scripts.test \
        --config 3DMatch --data-root data/ThreeDMatch --torch-weights <dir>

The collective backend is NCCL on cards and gloo with ``--device cpu``;
``--dist-backend`` names another (gloo for ranks that share one card,
which NCCL refuses).  Only rank 0 prints the summary.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import torch

STAGES = ("Ref", "Desc", "Keypt", "Inlier")


def make_dataset(cfg):
    """The test split of the loader for ``cfg.data.dataset``."""
    name = cfg.data.dataset
    if name in ("3DMatch", "3DLoMatch"):
        from buffer_tpu_torch.data.threedmatch import ThreeDMatchDataset
        return ThreeDMatchDataset("test", cfg)
    if name == "KITTI":
        from buffer_tpu_torch.data.kitti import KITTIDataset
        return KITTIDataset("test", cfg)
    if name == "ETH":
        from buffer_tpu_torch.data.eth import ETHDataset
        return ETHDataset("test", cfg)
    raise ValueError(f"no loader for dataset {name!r}")


def load_model(cfg, weights: Optional[str], torch_weights: Optional[str],
               device):
    """A model of ``cfg`` on ``device`` from a reference snapshot directory
    (``torch_weights``, each ``<dir>/<stage>/best.pth``) or per-stage
    checkpoints (``weights``, each ``<dir>/<stage>/best.msgpack`` of the JAX
    trainer where present, else ``<dir>/<stage>/best.pth``); a missing
    file raises."""
    if torch_weights:
        from buffer_tpu_torch.compat.torch_convert import load_reference_model
        return load_reference_model(
            cfg, {s: os.path.join(torch_weights, s, "best.pth")
                  for s in STAGES}, device)
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.train.checkpoint import (best_file,
                                                   merge_stage_checkpoints)
    model = BufferModel(cfg)
    model.load_state_dict(merge_stage_checkpoints(
        {s: best_file(weights, s) for s in STAGES}))
    return model.to(device)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Parses ``argv`` (default: the command line), evaluates and prints the
    summary; returns :func:`~buffer_tpu_torch.eval.harness.run_eval`'s dict."""
    from buffer_tpu_torch.config import PRESETS

    ap = argparse.ArgumentParser(prog="python -m buffer_tpu_torch.scripts.test")
    ap.add_argument("--config", default="3DMatch", choices=list(PRESETS))
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--weights", default=None,
                    help="directory of <stage>/best.msgpack (the JAX "
                         "trainer's) or this package's <stage>/best.pth")
    ap.add_argument("--torch-weights", default=None,
                    help="reference snapshot directory with <stage>/best.pth")
    ap.add_argument("--max-pairs", type=int, default=None)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="the miniature static plan of the tests")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--dist-backend", default=None,
                    help="collective backend under torchrun (default: nccl "
                         "on cards, gloo on the CPU)")
    args = ap.parse_args(argv)
    if not (args.weights or args.torch_weights):
        ap.error("need --weights or --torch-weights")

    import dataclasses

    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.config import make_cfg, shrink_static
    from buffer_tpu_torch.eval.harness import run_eval
    from buffer_tpu_torch.utils.dist import init_dp, rank_device

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        dev = rank_device(args.device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init_dp(args.dist_backend or ("nccl" if dev.type == "cuda" else "gloo"),
                "env://", int(os.environ["RANK"]), world)
    else:
        dev = resolve_device(args.device)
    cfg = make_cfg(args.config).with_stage("test")
    if args.tiny:
        cfg = shrink_static(cfg)
    if args.data_root:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                   root=args.data_root))

    model = load_model(cfg, args.weights, args.torch_weights, dev)
    log_dir = args.log_dir or f"log_{cfg.data.dataset}_{args.config}"
    out = run_eval(cfg, model, make_dataset(cfg), log_dir=log_dir,
                   max_pairs=args.max_pairs, device=dev)
    if world > 1:
        torch.distributed.destroy_process_group()
    if world == 1 or int(os.environ["RANK"]) == 0:
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in out.items()})
    return out


if __name__ == "__main__":
    main()
