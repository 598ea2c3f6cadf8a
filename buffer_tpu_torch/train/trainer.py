"""Stage-sequential trainer (counterpart of ``buffer_tpu/train/trainer.py``,
without its data-parallel step).

Port of the reference Trainer (ThreeDMatch/trainer.py) and stage loop
(ThreeDMatch/train.py:22-108): one :class:`Trainer` per stage, Ref -> Desc
-> Keypt -> Inlier, each training its stage with the others frozen.
``torch.optim.Adam`` over the active stage's parameters with L2 weight
decay added to the gradient (optax's ``chain(add_decayed_weights(wd),
adam(lr))``), the learning rate decayed by ``lr_decay`` every
``scheduler_interval`` epochs, a step skipped whole when any gradient is
not finite (trainer.py:203-209), validation every epoch, and the best
checkpoint kept by the stage's metric (trainer.py:70-87).
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, Iterable, NamedTuple, Optional

import torch

from buffer_tpu_torch import resolve_device
from buffer_tpu_torch.config import Config
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.pipeline.registration import PairInputs
from buffer_tpu_torch.pipeline.train_forward import (TrainDraws,
                                                     make_train_draws,
                                                     stage_loss)
from buffer_tpu_torch.train import checkpoint
from buffer_tpu_torch.utils.logging import MetricLogger

BEST_METRIC = {"Ref": "ref_loss", "Desc": "desc_loss",
               "Keypt": "det_loss", "Inlier": "match_loss"}


class TrainBatch(NamedTuple):
    inputs: PairInputs
    relt_pose: torch.Tensor   # [4, 4] ground truth, source -> target


def make_optimizer(cfg: Config, model: BufferModel, stage: str):
    """(Adam over ``stage``'s parameters, epoch -> learning rate)."""
    lr0 = cfg.optim.lr[stage]
    interval = cfg.optim.scheduler_interval[stage]

    def lr_for_epoch(epoch: int) -> float:
        return lr0 * (cfg.optim.lr_decay ** (epoch // interval))

    opt = torch.optim.Adam(getattr(model, stage).parameters(), lr=lr0,
                           weight_decay=cfg.optim.weight_decay)
    return opt, lr_for_epoch


def train_step(model: BufferModel, optimizer: torch.optim.Optimizer,
               stage: str, batch: TrainBatch, draws: TrainDraws,
               det_margin: float, device=None):
    """One optimizer step of ``stage``; returns (loss, stats) detached.

    A parameter the loss does not reach gets a zero gradient, so weight
    decay moves it as it does in the JAX package.  When any gradient is
    not finite, neither the parameters nor Adam's state move
    (``stats["grad_finite"]`` = 0); the running statistics keep the
    forward's update either way."""
    optimizer.zero_grad(set_to_none=True)
    loss, stats = stage_loss(model, stage, batch.inputs, batch.relt_pose,
                             draws, train=True, det_margin=det_margin,
                             device=device)
    loss.backward()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    finite = torch.stack([torch.isfinite(p.grad).all() for p in params]).all()
    if bool(finite):
        optimizer.step()
    stats = {k: v.detach() for k, v in stats.items()}
    stats["grad_finite"] = finite.to(torch.float32)
    return loss.detach(), stats


def eval_step(model: BufferModel, stage: str, batch: TrainBatch,
              draws: TrainDraws, det_margin: float, device=None):
    """Loss and stats of ``stage`` with every stage in eval mode."""
    with torch.no_grad():
        return stage_loss(model, stage, batch.inputs, batch.relt_pose, draws,
                          train=False, det_margin=det_margin, device=device)


class Trainer:
    """Trains one stage of ``model`` on ``device`` (default: the CUDA card;
    the model must live there).  Iterators yield :class:`TrainBatch`;
    random draws come from the ``generator`` given to :meth:`fit`."""

    def __init__(self, cfg: Config, model: BufferModel, stage: str,
                 save_dir: str, logger: Optional[MetricLogger] = None,
                 device=None):
        self.cfg = cfg
        self.model = model
        self.stage = stage
        self.save_dir = save_dir
        self.device = resolve_device(device)
        self.det_margin = 1.0 if cfg.data.dataset == "KITTI" else 1.05
        self.optimizer, self.lr_for_epoch = make_optimizer(cfg, model, stage)
        self.logger = logger or MetricLogger(os.path.join(save_dir,
                                                          "metrics.jsonl"))
        self.best = math.inf

    def set_epoch_lr(self, epoch: int) -> float:
        lr = self.lr_for_epoch(epoch)
        for g in self.optimizer.param_groups:
            g["lr"] = lr
        return lr

    def step(self, batch: TrainBatch, draws: TrainDraws):
        return train_step(self.model, self.optimizer, self.stage, batch,
                          draws, self.det_margin, self.device)

    def fit(self, train_iter_fn: Callable[[int], Iterable],
            val_iter_fn: Callable[[int], Iterable],
            generator: torch.Generator) -> BufferModel:
        for epoch in range(self.cfg.train.epoch):
            self.set_epoch_lr(epoch)
            self._epoch(train_iter_fn(epoch), epoch, generator)
            self.end_epoch(epoch, self.evaluate(val_iter_fn(epoch), generator))
        return self.model

    def _epoch(self, it, epoch: int, generator: torch.Generator) -> None:
        t0 = time.time()
        n = 0
        agg: Dict[str, float] = {}
        for batch in it:
            _, stats = self.step(batch, make_train_draws(self.cfg, generator,
                                                         self.device))
            n += 1
            for k, v in stats.items():
                agg[k] = agg.get(k, 0.0) + float(v)
            if n % 200 == 0:
                self.logger.log(epoch=epoch, iter=n, split="train",
                                stage=self.stage,
                                sec_per_iter=(time.time() - t0) / n,
                                **{k: v / n for k, v in agg.items()})
            if n >= self.cfg.train.max_iter:
                break

    def evaluate(self, it, generator: torch.Generator) -> Dict[str, float]:
        agg: Dict[str, float] = {}
        n = 0
        for batch in it:
            _, stats = eval_step(self.model, self.stage, batch,
                                 make_train_draws(self.cfg, generator,
                                                  self.device),
                                 self.det_margin, self.device)
            n += 1
            for k, v in stats.items():
                agg[k] = agg.get(k, 0.0) + float(v)
        return {k: v / max(n, 1) for k, v in agg.items()}

    def checkpoint_path(self, name) -> str:
        return os.path.join(self.save_dir, self.stage, f"{name}.pth")

    def end_epoch(self, epoch: int, res: Dict[str, float]) -> None:
        """Logs the validation result and writes the epoch's checkpoint, and
        the best one when the stage's metric improved."""
        self.logger.log(epoch=epoch, split="val", stage=self.stage, **res)
        metric = res.get(BEST_METRIC[self.stage], math.inf)
        if metric < self.best:
            self.best = metric
            checkpoint.save(self.model, self.checkpoint_path("best"))
        checkpoint.save(self.model, self.checkpoint_path(epoch))
