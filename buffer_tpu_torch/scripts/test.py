"""Evaluation entry point (counterpart of the repository's ``scripts/test.py``;
reference ``ThreeDMatch/test.py``, ``KITTI/test.py``,
``generalization/*/test.py``; all seven configurations are presets):

    python -m buffer_tpu_torch.scripts.test --config 3DMatch \\
        --data-root data/ThreeDMatch --torch-weights <snapshot dir>
    python -m buffer_tpu_torch.scripts.test --config KITTI \\
        --data-root data/KITTI --weights <dir of Ref/ Desc/ Keypt/ Inlier/>

``--torch-weights`` takes a reference snapshot directory
(``<stage>/best.pth`` holding the whole composite state dict);
``--weights`` this package's own per-stage checkpoints
(``<stage>/best.pth`` written by ``train.checkpoint``).  Runs on the CUDA
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

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


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Parses ``argv`` (default: the command line), evaluates and prints the
    summary; returns :func:`~buffer_tpu_torch.eval.harness.run_eval`'s dict."""
    from buffer_tpu_torch.config import PRESETS

    ap = argparse.ArgumentParser(prog="python -m buffer_tpu_torch.scripts.test")
    ap.add_argument("--config", default="3DMatch", choices=list(PRESETS))
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--weights", default=None,
                    help="directory of this package's <stage>/best.pth")
    ap.add_argument("--torch-weights", default=None,
                    help="reference snapshot directory with <stage>/best.pth")
    ap.add_argument("--max-pairs", type=int, default=None)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="the miniature static plan of the tests")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    if not (args.weights or args.torch_weights):
        ap.error("need --weights or --torch-weights")

    import dataclasses

    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.config import make_cfg, shrink_static
    from buffer_tpu_torch.eval.harness import run_eval

    dev = resolve_device(args.device)
    cfg = make_cfg(args.config).with_stage("test")
    if args.tiny:
        cfg = shrink_static(cfg)
    if args.data_root:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                   root=args.data_root))

    if args.torch_weights:
        from buffer_tpu_torch.compat.torch_convert import load_reference_model
        model = load_reference_model(
            cfg, {s: os.path.join(args.torch_weights, s, "best.pth")
                  for s in STAGES}, dev)
    else:
        from buffer_tpu_torch.models.composite import BufferModel
        from buffer_tpu_torch.train.checkpoint import merge_stage_checkpoints
        model = BufferModel(cfg)
        model.load_state_dict(merge_stage_checkpoints(
            {s: os.path.join(args.weights, s, "best.pth") for s in STAGES}))
        model = model.to(dev)

    log_dir = args.log_dir or f"log_{cfg.data.dataset}_{args.config}"
    out = run_eval(cfg, model, make_dataset(cfg), log_dir=log_dir,
                   max_pairs=args.max_pairs, device=dev)
    print({k: round(v, 4) if isinstance(v, float) else v
           for k, v in out.items()})
    return out


if __name__ == "__main__":
    main()
