"""Stage-sequential trainer (counterpart of ``buffer_tpu/train/trainer.py``).

Port of the reference Trainer (ThreeDMatch/trainer.py) and stage loop
(ThreeDMatch/train.py:22-108): one :class:`Trainer` per stage, Ref -> Desc
-> Keypt -> Inlier, each training its stage with the others frozen.
``torch.optim.Adam`` over the active stage's parameters with L2 weight
decay added to the gradient (optax's ``chain(add_decayed_weights(wd),
adam(lr))``), the learning rate decayed by ``lr_decay`` every
``scheduler_interval`` epochs, a step skipped whole when any gradient is
not finite (trainer.py:203-209), validation every epoch, and the best
checkpoint kept by the stage's metric (trainer.py:70-87).

:func:`make_dp_train_step` is the data-parallel step over fragment pairs,
one pair a rank of a ``torch.distributed`` group (``utils/dist.py``);
:func:`mean_train_step` is the same step in one process, the reference it
is held to.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from buffer_tpu_torch import resolve_device
from buffer_tpu_torch.config import Config
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.pipeline.registration import PairInputs
from buffer_tpu_torch.pipeline.train_forward import (TrainDraws,
                                                     make_train_draws,
                                                     stage_loss)
from buffer_tpu_torch.train import checkpoint
from buffer_tpu_torch.utils.dist import group_size, group_src
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
    loss, stats, grads = _loss_and_grads(model, optimizer, stage, batch,
                                         draws, det_margin, device)
    stats["grad_finite"] = _finite_step(optimizer, grads)
    return loss, stats


def _stage_params(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for g in optimizer.param_groups for p in g["params"]]


def _running_stats(model: BufferModel, stage: str) -> List[torch.Tensor]:
    """The batch norms' running means and variances of ``stage``."""
    return [b for name, b in getattr(model, stage).named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def _finite_step(optimizer: torch.optim.Optimizer,
                 grads: List[torch.Tensor]) -> torch.Tensor:
    """Sets the stage's gradients to ``grads`` and steps unless one of them
    is not finite; returns the finite flag (float32)."""
    for p, g in zip(_stage_params(optimizer), grads):
        p.grad = g
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    if bool(finite):
        optimizer.step()
    return finite.to(torch.float32)


def _loss_and_grads(model, optimizer, stage, batch, draws, det_margin, dev):
    """Loss, stats and the stage's gradients (zero where the loss does not
    reach a parameter) of one pair."""
    optimizer.zero_grad(set_to_none=True)
    loss, stats = stage_loss(model, stage, batch.inputs, batch.relt_pose,
                             draws, train=True, det_margin=det_margin,
                             device=dev)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in _stage_params(optimizer)]
    return loss.detach(), {k: v.detach() for k, v in stats.items()}, grads


def make_dp_train_step(model: BufferModel, optimizer: torch.optim.Optimizer,
                       stage: str, group=None, det_margin: float = 1.05,
                       device=None):
    """The data-parallel training step (``buffer_tpu/train/trainer.py:109-163``):
    returns ``step(batch, draws) -> (loss, stats)`` that trains ``stage`` on
    this rank's pair of ``group`` (default: the default group), every rank
    calling it once a step.

    Making the step broadcasts every parameter and buffer of ``model`` from
    the group's rank 0, so the replicas start equal (Adam's state starts
    empty on every rank).  A step computes this rank's loss and gradients,
    zero where the loss does not reach a parameter, then all-reduces them,
    in one flat buffer in parameter order, to their mean over ranks.  The
    finite check reads the reduced gradients, so one bad rank skips the step
    on every rank: neither the parameters nor Adam's state move and
    ``grad_finite`` is 0 everywhere.  The running statistics that this
    rank's forward moved (the active stage's; frozen stages run in eval
    mode) are all-reduced to their mean, the update with the mean batch
    statistic, as JAX averages its updates.  ``loss`` and ``stats`` are
    their means over ranks."""
    dev = resolve_device(device)
    world = group_size(group)
    src = group_src(group)
    with torch.no_grad():
        for t in model.state_dict().values():
            dist.broadcast(t, src, group=group)
    running = _running_stats(model, stage)

    def mean(ts: List[torch.Tensor]) -> List[torch.Tensor]:
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= world
        return list(torch.split(flat, [t.numel() for t in ts]))

    def step(batch: TrainBatch, draws: TrainDraws):
        loss, stats, grads = _loss_and_grads(model, optimizer, stage, batch,
                                             draws, det_margin, dev)
        grads = [m.view_as(g) for m, g in zip(mean(grads), grads)]
        finite = _finite_step(optimizer, grads)
        if running:
            with torch.no_grad():
                for b, m in zip(running, mean(running)):
                    b.copy_(m.view_as(b))
        keys = list(stats)
        means = mean([loss.reshape(1)] + [stats[k].reshape(1) for k in keys])
        stats = {k: m[0] for k, m in zip(keys, means[1:])}
        stats["grad_finite"] = finite
        return means[0][0], stats

    return step


def mean_train_step(model: BufferModel, optimizer: torch.optim.Optimizer,
                    stage: str, batches, draws, det_margin: float = 1.05,
                    device=None):
    """:func:`make_dp_train_step`'s step in one process over the pairs
    ``batches`` with ``draws`` (one each): the mean of the per-pair
    gradients, the mean of the per-pair running-statistic updates (each pair
    from the same statistics), and the step skipped whole when a mean
    gradient is not finite.  Returns (mean loss, mean stats)."""
    dev = resolve_device(device)
    running = _running_stats(model, stage)
    buffers = list(getattr(model, stage).buffers())
    start = [b.clone() for b in buffers]
    runs = []
    for batch, dr in zip(batches, draws):
        with torch.no_grad():
            for b, s in zip(buffers, start):
                b.copy_(s)
        loss, stats, grads = _loss_and_grads(model, optimizer, stage, batch,
                                             dr, det_margin, dev)
        runs.append((loss, stats, [g.clone() for g in grads],
                     [b.clone() for b in running]))
    n = len(runs)
    mean = lambda ts: torch.stack(ts).sum(0) / n
    grads = [mean([r[2][i] for r in runs]) for i in range(len(runs[0][2]))]
    finite = _finite_step(optimizer, grads)
    with torch.no_grad():
        for i, b in enumerate(running):
            b.copy_(mean([r[3][i] for r in runs]))
    stats = {k: mean([r[1][k] for r in runs]) for k in runs[0][1]}
    stats["grad_finite"] = finite
    return mean([r[0] for r in runs]), stats


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
