"""Training entry point (counterpart of the repository's ``scripts/train.py``;
reference ``ThreeDMatch/train.py``, ``KITTI/train.py``): the four stages in
sequence, Ref -> Desc -> Keypt -> Inlier, each with the others frozen and
merged in from their best checkpoints, the best checkpoint of each stage
kept under ``<out>/<stage>/best.pth``:

    python -m buffer_tpu_torch.scripts.train --config 3DMatch \\
        --data-root data/ThreeDMatch --out snapshot/3dmatch
    python -m buffer_tpu_torch.scripts.train --config KITTI --tiny \\
        --device cpu --data-root <fixture tree> --out <dir> --max-iter 2

A stage takes the other stages' weights from ``<out>/<other>/``, else from
``--resume``'s, and only that stage's entries of the file: ``best.msgpack``
(the JAX trainer's) where present, else ``best.pth``.  Runs on the CUDA
card unless ``--device cpu`` is given.

A run repeats: each split's loader draws its augmentation (swap, rotation,
jitter) from a ``RandomState`` seeded from ``manual_seed`` (the reference's
loaders draw unseeded), each epoch's order and ``prepare_pair`` from
``RandomState(manual_seed + epoch)`` (``10000 + epoch`` for validation), and
the training draws from a generator seeded with ``manual_seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch


def data_iter(cfg, dataset, rs_seed: int, device) -> Iterator:
    """Dataset items in an order drawn from ``RandomState(rs_seed)``, each
    made into a :class:`~buffer_tpu_torch.train.trainer.TrainBatch` on
    ``device`` by ``prepare_pair`` drawing from the same ``RandomState``."""
    from buffer_tpu_torch.data.preprocess import prepare_pair
    from buffer_tpu_torch.train.trainer import TrainBatch

    rs = np.random.RandomState(rs_seed)
    for i in rs.permutation(len(dataset)):
        item = dataset[int(i)]
        inputs = prepare_pair(cfg, item["src_fds_pts"], item["tgt_fds_pts"],
                              rs=rs, already_downsampled=True, device=device)
        yield TrainBatch(inputs=inputs, relt_pose=torch.as_tensor(
            item["relt_pose"], device=device))


def make_dataset(cfg, split: str, rs: np.random.RandomState):
    """The ``split`` of the loader for ``cfg.data.dataset``."""
    if cfg.data.dataset == "KITTI":
        from buffer_tpu_torch.data.kitti import KITTIDataset
        return KITTIDataset(split, cfg, rs=rs)
    from buffer_tpu_torch.data.threedmatch import ThreeDMatchDataset
    return ThreeDMatchDataset(split, cfg, rs=rs)


def load_other_stages(model, stage: str, out: str,
                      resume: Optional[str]) -> None:
    """Each of the model's stages but ``stage`` from ``<out>/<other>/``,
    else from ``<resume>/<other>/``, taking only that stage's entries (the
    freeze-and-merge of ThreeDMatch/train.py:37-47); in each directory
    ``best.msgpack`` (the JAX trainer's) where present, else ``best.pth``."""
    from buffer_tpu_torch.train import checkpoint
    for other in model.cfg.train.all_stage:
        if other == stage:
            continue
        src = checkpoint.best_file(out, other)
        if not os.path.exists(src) and resume:
            src = checkpoint.best_file(resume, other)
        if os.path.exists(src):
            merged = checkpoint.merge_stage_checkpoints({other: src})
            getattr(model, other).load_state_dict(
                {k[len(other) + 1:]: v for k, v in merged.items()})


def main(argv: Optional[Sequence[str]] = None):
    """Parses ``argv`` (default: the command line) and trains; returns the
    model."""
    ap = argparse.ArgumentParser(prog="python -m buffer_tpu_torch.scripts.train")
    ap.add_argument("--config", default="3DMatch", choices=["3DMatch", "KITTI"])
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--stages", nargs="*", default=None)
    ap.add_argument("--resume", default=None,
                    help="snapshot dir to take the other stages from")
    ap.add_argument("--tiny", action="store_true",
                    help="the miniature static plan of the tests")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.config import make_cfg, shrink_static
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.train.trainer import Trainer

    dev = resolve_device(args.device)
    cfg = make_cfg(args.config)
    if args.tiny:
        cfg = shrink_static(cfg)
    over = {k: v for k, v in (("epoch", args.epochs),
                              ("max_iter", args.max_iter)) if v is not None}
    if over:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **over))
    if args.data_root:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                   root=args.data_root))
    out = args.out or os.path.join("snapshot", time.strftime("%m%d%H%M"))
    os.makedirs(out, exist_ok=True)

    seed = cfg.data.manual_seed
    model = BufferModel(cfg, seed=seed).to(dev)
    for stage in args.stages or cfg.train.all_stage:
        scfg = cfg.with_stage(stage)
        load_other_stages(model, stage, out, args.resume)
        train_ds = make_dataset(scfg, "train", np.random.RandomState(seed))
        val_ds = make_dataset(scfg, "val", np.random.RandomState(seed + 1))
        Trainer(scfg, model, stage, out, device=dev).fit(
            lambda epoch: data_iter(scfg, train_ds, seed + epoch, dev),
            lambda epoch: data_iter(scfg, val_ds, 10_000 + epoch, dev),
            generator=torch.Generator(device=dev).manual_seed(seed))
    return model


if __name__ == "__main__":
    main()
