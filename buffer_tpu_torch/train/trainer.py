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

:func:`make_train_step` and :func:`make_eval_step` are the counterparts of
the JAX package's jitted steps: on the card a step runs as a captured CUDA
graph, replayed on every call after the first of its input signature;
:func:`train_step` and :func:`eval_step` run the same step operator by
operator.  :func:`make_dp_train_step` is the data-parallel step over
fragment pairs, one pair a rank of a ``torch.distributed`` group
(``utils/dist.py``), on the card two graphs around the eager all-reduce;
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
from buffer_tpu_torch.core import graphs
from buffer_tpu_torch.kernels import cuda, sites
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
    """(Adam over ``stage``'s parameters, epoch -> learning rate), with
    Adam's state made here, before any step.

    Where the parameters lie on the card, Adam is ``capturable`` (its step
    counter stays on the card, so a step reads nothing back to the host)
    and its learning rate is a 0-dim float32 tensor there, which
    :func:`set_lr` fills in place: a CUDA graph reads the tensor it
    captured.  On the CPU it is the float-rate Adam, as the JAX package's
    tolerances were set against."""
    lr0 = cfg.optim.lr[stage]
    interval = cfg.optim.scheduler_interval[stage]

    def lr_for_epoch(epoch: int) -> float:
        return lr0 * (cfg.optim.lr_decay ** (epoch // interval))

    params = list(getattr(model, stage).parameters())
    dev = params[0].device
    card = dev.type == "cuda"
    lr = torch.full((), lr0, dtype=torch.float32, device=dev) if card else lr0
    opt = torch.optim.Adam(params, lr=lr, weight_decay=cfg.optim.weight_decay,
                           capturable=card)
    for p in params:      # what Adam makes at its first step
        opt.state[p] = {
            "step": torch.zeros((), dtype=torch.float32, device=dev)
            if card else torch.tensor(0.0),
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(p,
                                           memory_format=torch.preserve_format)}
    return opt, lr_for_epoch


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Sets every group's learning rate; a tensor rate is filled in place."""
    for g in optimizer.param_groups:
        if torch.is_tensor(g["lr"]):
            g["lr"].fill_(lr)
        else:
            g["lr"] = lr


def train_step(model: BufferModel, optimizer: torch.optim.Optimizer,
               stage: str, batch: TrainBatch, draws: TrainDraws,
               det_margin: float, device=None):
    """One optimizer step of ``stage``, operator by operator; returns
    (loss, stats) detached.

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
    """Sets the stage's gradients to ``grads`` and steps, then keeps the
    parameters and Adam's state from before the step where one of the
    gradients is not finite (a select on the device: nothing is read back
    to the host); returns the finite flag (float32)."""
    params = _stage_params(optimizer)
    for p, g in zip(params, grads):
        p.grad = g
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    held = params + [t for p in params for t in optimizer.state[p].values()]
    before = [t.detach().clone() for t in held]
    optimizer.step()
    with torch.no_grad():
        for t, old in zip(held, before):
            t.copy_(torch.where(finite, t, old))
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
    at zero on every rank).  A step computes this rank's loss and
    gradients, zero where the loss does not reach a parameter, then
    all-reduces them, in one flat buffer in parameter order, to their mean
    over ranks.  The finite check reads the reduced gradients, so one bad
    rank skips the step on every rank: neither the parameters nor Adam's
    state move and ``grad_finite`` is 0 everywhere.  The running
    statistics that this rank's forward moved (the active stage's; frozen
    stages run in eval mode) are all-reduced to their mean, the update with
    the mean batch statistic, as JAX averages its updates.  ``loss`` and
    ``stats`` are their means over ranks.

    On the card the step is a :class:`_DPProgram` for each input signature:
    two CUDA graphs around the eager all-reduce (collectives of the group's
    backend are not captured).  On the CPU the same parts run eagerly over
    the program's static buffers.  ``step.eager`` is the step operator by
    operator, the reference that the program is held to."""
    dev = resolve_device(device)
    world = group_size(group)
    src = group_src(group)
    with torch.no_grad():
        for t in model.state_dict().values():
            dist.broadcast(t, src, group=group)
    running = _running_stats(model, stage)
    params = _stage_params(optimizer)
    flat = lambda ts: torch.cat([t.reshape(-1) for t in ts])

    def local(batch: TrainBatch, draws: TrainDraws):
        """This rank's part before the all-reduce: (the flat gradients, the
        flat running statistics or None, the flat loss and stats), and the
        stats' keys."""
        loss, stats, grads = _loss_and_grads(model, optimizer, stage, batch,
                                             draws, det_margin, dev)
        keys = tuple(stats)
        return ((flat(grads), flat(running) if running else None,
                 flat([loss.reshape(1)] + [stats[k].reshape(1) for k in keys])),
                keys)

    def reduce(flats) -> None:
        """Each flat buffer, in place, to its mean over the group's ranks."""
        for f in flats:
            if f is not None:
                dist.all_reduce(f, group=group)
                f /= world

    def apply(flats) -> torch.Tensor:
        """The part after the all-reduce: the finite step on the mean
        gradients, the running statistics set to their mean."""
        grads = [m.view_as(p) for m, p in
                 zip(torch.split(flats[0], [p.numel() for p in params]), params)]
        finite = _finite_step(optimizer, grads)
        if running:
            with torch.no_grad():
                for b, m in zip(running, torch.split(
                        flats[1], [b.numel() for b in running])):
                    b.copy_(m.view_as(b))
        return finite

    def result(flats, keys, finite):
        means = flats[2]
        stats = {k: means[i + 1] for i, k in enumerate(keys)}
        stats["grad_finite"] = finite
        return means[0], stats

    def eager(batch: TrainBatch, draws: TrainDraws):
        flats, keys = local(batch, draws)
        reduce(flats)
        return result(flats, keys, apply(flats))

    held = lambda: step_tensors(model, optimizer)
    step = graphs.cache(lambda batch, draws: _DPProgram(
        (local, reduce, apply, result), held, dev, batch, draws), _signature)
    step.eager = eager
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


def _fields(batch: TrainBatch, draws: TrainDraws) -> tuple:
    """Every field of a step's inputs, in order (None for an absent one)."""
    return (*batch.inputs, batch.relt_pose, *draws)


def _signature(batch: TrainBatch, draws: TrainDraws) -> tuple:
    """The signature of every field and whether the kernels' plain
    versions are in force: the key of a captured step."""
    return graphs.signature(_fields(batch, draws)), sites.plain_active()


def step_tensors(model: BufferModel, optimizer=None) -> List[torch.Tensor]:
    """Every tensor a captured step reads or writes in place: the model's
    parameters and buffers, and Adam's state and tensor learning rate."""
    held = [*model.parameters(), *model.buffers()]
    if optimizer is not None:
        held += [t for st in optimizer.state.values() for t in st.values()]
        held += [g["lr"] for g in optimizer.param_groups
                 if torch.is_tensor(g["lr"])]
    return held


class _Program:
    """A step's static inputs on the card and the guard on the tensors a
    graph captured (:func:`step_tensors`).

    ``first``: the first call's result, computed eagerly on a side stream
    before any capture (``graphs.warm``); ``capture_s``: the host seconds
    that the captures took."""

    def __init__(self, held: Callable[[], List[torch.Tensor]],
                 dev: torch.device, batch: TrainBatch, draws: TrainDraws):
        self.dev = dev
        self.guard = graphs.Guard(held, (
            "a compiled training step: the model's parameters or buffers "
            "or Adam's state are not the tensors the graphs were captured "
            "with (load weights in place, e.g. load_state_dict, or make a "
            "new step)"))
        self.batch, self.draws = graphs.empty_like((batch, draws), dev)
        self.static = _fields(self.batch, self.draws)
        graphs.load(self.static, _fields(batch, draws))

    def _check(self, batch: TrainBatch, draws: TrainDraws) -> None:
        self.guard.check()
        graphs.load(self.static, _fields(batch, draws))


class _StepProgram(_Program):
    """One input signature's step ``run(batch, draws)`` as one CUDA graph:
    the first call runs eagerly (for a training step a real step, which
    moves the parameters and Adam's state), then the step is captured, and
    every later call copies its inputs into the static ones, replays the
    graph and returns copies of its outputs.  A replay runs no Python, so
    the kernels' launch counts are recorded at capture and added on each
    replay."""

    def __init__(self, run, held, dev, batch, draws):
        super().__init__(held, dev, batch, draws)
        self.first = graphs.clone(graphs.warm(
            lambda: run(self.batch, self.draws), dev))
        t0 = time.perf_counter()
        self.graph, self.out, self.launches = graphs.capture_graph(
            lambda: run(self.batch, self.draws), torch.cuda.graph_pool_handle())
        self.capture_s = time.perf_counter() - t0

    def __call__(self, batch: TrainBatch, draws: TrainDraws):
        self._check(batch, draws)
        self.graph.replay()
        cuda.add_launches(self.launches)
        return graphs.clone(self.out)


class _DPProgram(_Program):
    """One input signature's data-parallel step: graph A (loss, gradients,
    stats and the moved running statistics, into flat buffers), the eager
    all-reduce of those buffers with the group's own backend, graph B (the
    finite step on the mean gradients, the running statistics set to their
    mean).  Both graphs share one memory pool and replay in turn on one
    stream; the flat buffers are A's outputs, held by the program.  On the
    CPU nothing is captured: A's body runs and its outputs are copied into
    the same static buffers, then the all-reduce and B's body run, in the
    program's order over the program's buffers."""

    def __init__(self, parts, held, dev, batch, draws):
        super().__init__(held, dev, batch, draws)
        self.local, self.reduce, self.apply, self.result = parts

        def step():
            flats, keys = self.local(self.batch, self.draws)
            self.reduce(flats)
            return (graphs.clone(self.result(flats, keys, self.apply(flats))),
                    flats, keys)
        self.first, flats, self.keys = graphs.warm(step, dev)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            pool = torch.cuda.graph_pool_handle()
            self.graph_a, (self.flats, _), self.launches_a = \
                graphs.capture_graph(lambda: self.local(self.batch,
                                                        self.draws), pool)
            self.graph_b, self.finite, self.launches_b = graphs.capture_graph(
                lambda: self.apply(self.flats), pool)
        else:
            self.flats = tuple(None if f is None else torch.empty_like(f)
                               for f in flats)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, batch: TrainBatch, draws: TrainDraws):
        self._check(batch, draws)
        if self.dev.type == "cuda":
            self.graph_a.replay()
            cuda.add_launches(self.launches_a)
        else:
            graphs.load(self.flats, self.local(self.batch, self.draws)[0])
        self.reduce(self.flats)
        if self.dev.type == "cuda":
            self.graph_b.replay()
            cuda.add_launches(self.launches_b)
            finite = self.finite
        else:
            finite = self.apply(self.flats)
        return graphs.clone(self.result(self.flats, self.keys, finite))


def make_train_step(model: BufferModel, optimizer: torch.optim.Optimizer,
                    stage: str, det_margin: float, device=None):
    """The compiled training step (counterpart of
    ``buffer_tpu/train/trainer.py:64``'s ``jax.jit``): returns
    ``fn(batch, draws) -> (loss, stats)``, which does what
    :func:`train_step` does.

    On the card (the default) the step runs as a CUDA graph, one for each
    input signature (shapes, dtypes, which fields are None, and whether the
    kernels' plain versions are in force), captured on the first call after
    that call's eager step: forward, backward, the finite select and Adam's
    step, Adam capturable with its tensor learning rate
    (:func:`make_optimizer`).  The graph reads and writes the model's
    parameters and buffers and Adam's state in place: a replaced tensor
    makes the next call raise, and nothing may load the optimizer's state
    between calls.  A capture that fails raises; nothing falls back to
    eager.  On the CPU ``fn`` runs :func:`train_step`."""
    dev = resolve_device(device)
    run = lambda batch, draws: train_step(model, optimizer, stage, batch,
                                          draws, det_margin, dev)
    return _compiled(run, lambda: step_tensors(model, optimizer), dev)


def make_eval_step(model: BufferModel, stage: str, det_margin: float,
                   device=None):
    """The compiled evaluation step (``buffer_tpu/train/trainer.py:98``):
    ``fn(batch, draws) -> (loss, stats)`` as :func:`eval_step`, on the card
    a CUDA graph a signature as in :func:`make_train_step` (the first
    call's eager result is its step: evaluation moves nothing), on the CPU
    :func:`eval_step` itself."""
    dev = resolve_device(device)
    run = lambda batch, draws: eval_step(model, stage, batch, draws,
                                         det_margin, dev)
    return _compiled(run, lambda: step_tensors(model), dev)


def _compiled(run, held, dev: torch.device):
    """``run`` off the card; on it, a :class:`_StepProgram` a signature."""
    if dev.type != "cuda":
        return run
    return graphs.cache(lambda batch, draws: _StepProgram(
        run, held, dev, batch, draws), _signature)


def host_stats(stats: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """A step's stats as host floats, in one device-to-host copy."""
    keys = list(stats)
    vals = torch.stack([stats[k].reshape(()) for k in keys]).tolist()
    return dict(zip(keys, vals))


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
        # the previous stage's gradients (a graph's static ones) go, so its
        # programs' memory can be freed with them
        model.zero_grad(set_to_none=True)
        self.optimizer, self.lr_for_epoch = make_optimizer(cfg, model, stage)
        self.train_fn = make_train_step(model, self.optimizer, stage,
                                        self.det_margin, self.device)
        self.eval_fn = make_eval_step(model, stage, self.det_margin,
                                      self.device)
        self.logger = logger or MetricLogger(os.path.join(save_dir,
                                                          "metrics.jsonl"))
        self.best = math.inf

    def set_epoch_lr(self, epoch: int) -> float:
        lr = self.lr_for_epoch(epoch)
        set_lr(self.optimizer, lr)
        return lr

    def step(self, batch: TrainBatch, draws: TrainDraws):
        return self.train_fn(batch, draws)

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
            for k, v in host_stats(stats).items():
                agg[k] = agg.get(k, 0.0) + v
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
            _, stats = self.eval_fn(batch, make_train_draws(
                self.cfg, generator, self.device))
            n += 1
            for k, v in host_stats(stats).items():
                agg[k] = agg.get(k, 0.0) + v
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
