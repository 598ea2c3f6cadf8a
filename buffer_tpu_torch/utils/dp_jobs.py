"""Rank programs for :func:`buffer_tpu_torch.utils.dist.launch`: data-parallel
registration rounds, data-parallel training steps over given pairs and
``run_eval`` over a dataset tree, each rank reporting what it computed, the
kernel launches it made and its times.
``utils/dp_scaling.py``, ``chip_smoke.py`` and the tests run them; each
takes one payload dict of CPU tensors and returns CPU tensors."""

from __future__ import annotations

import time
from typing import Any, Dict

import torch
import torch.distributed as dist

from buffer_tpu_torch.utils.dist import rank_device


def _model(payload: Dict[str, Any], dev):
    from buffer_tpu_torch.models.composite import BufferModel
    model = BufferModel(payload["cfg"])
    model.load_state_dict(payload["state"])
    return model.to(dev).eval()


def _synchronize(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches():
    from buffer_tpu_torch.kernels import cuda
    return cuda.launch_counts()


def register_job(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Registers ``payload["pairs"]`` (CPU ``PairInputs``) with their
    ``draws`` through ``make_dp_register`` in rounds of one pair a rank (the
    last round padded with its last pair), then, with ``iters``, times
    ``warmup`` + ``iters`` more rounds of this rank's first pair.  Payload:
    ``cfg``, ``state`` (the model's state dict), ``pairs``, ``draws``,
    ``device`` (None: this rank's card), ``iters``, ``warmup``.  Returns the
    gathered ``pose`` [n, 4, 4] and ``num_mutual`` [n], this rank's
    ``launches`` and ``ms`` a round, its ``pairs_per_s`` over the timed
    rounds (all ranks' pairs) and peak device memory."""
    from buffer_tpu_torch.eval.harness import make_dp_register
    dev = rank_device(payload["device"])
    rank, world = dist.get_rank(), dist.get_world_size()
    model = _model(payload, dev)
    fn = make_dp_register(model)
    pairs, draws = payload["pairs"], payload["draws"]
    n = len(pairs)
    poses, mutuals, launches, ms = [], [], [], []
    for k in range(0, n, world):
        j = min(k + rank, n - 1)
        before = _launches()
        _synchronize(dev)
        t0 = time.perf_counter()
        res = fn(pairs[j], draws[j], device=dev)
        _synchronize(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
        after = _launches()
        launches.append({name: after[name] - before[name] for name in after})
        real = min(world, n - k)
        poses.append(res.pose[:real].cpu())
        mutuals.append(res.num_mutual[:real].cpu())
    out = {"rank": rank, "world": world, "device": str(dev),
           "pose": torch.cat(poses), "num_mutual": torch.cat(mutuals),
           "launches": launches, "round_ms": ms, "pairs_per_s": None}
    iters = payload.get("iters", 0)
    if iters:
        j = min(rank, n - 1)
        for _ in range(payload.get("warmup", 1)):
            fn(pairs[j], draws[j], device=dev)
        _synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(pairs[j], draws[j], device=dev)
        _synchronize(dev)
        dist.barrier()
        out["pairs_per_s"] = world * iters / (time.perf_counter() - t0)
    if dev.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def train_job(payload: Dict[str, Any]) -> Dict[str, Any]:
    """For each stage of ``payload["stages"]``, from the model state
    ``state``: a fresh Adam (``make_optimizer``) and ``make_dp_train_step``,
    then one step a set of draws in ``draws[stage]`` (a list of steps, each
    a list of ``TrainDraws`` by rank) on this rank's pair of ``batches``
    (a list of steps, each a list of ``TrainBatch`` by rank).  With
    ``deterministic``, under PyTorch's deterministic algorithms; with
    ``adam``, each step also returns Adam's state.  With ``eager``, each
    step first runs ``step.eager`` (the step operator by operator) and
    records it under ``"eager"`` the same way (Adam's state included),
    then puts the model and Adam back in place and runs the step itself.
    Returns by stage each
    step's loss, stats, the active stage's state after it (parameters and
    running statistics), the keys of the other stages it changed, its
    launches and ms (host clock around the synchronized step), and the
    stage's peak device memory."""
    from buffer_tpu_torch.train.trainer import (make_dp_train_step,
                                                make_optimizer, step_tensors)
    dev = rank_device(payload["device"])
    rank = dist.get_rank()
    cfg = payload["cfg"]
    det_margin = 1.0 if cfg.data.dataset == "KITTI" else 1.05
    if payload.get("deterministic"):
        torch.use_deterministic_algorithms(True, warn_only=True)
    model = _model(payload, dev)
    cpu = lambda sd: {k: v.detach().cpu().clone() for k, v in sd.items()}
    out: Dict[str, Any] = {"rank": rank, "device": str(dev), "stages": {}}
    for stage in payload["stages"]:
        model.load_state_dict(payload["state"])
        optimizer, _ = make_optimizer(cfg, model, stage)
        step = make_dp_train_step(model, optimizer, stage, det_margin=det_margin,
                                  device=dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        def run(fn, batch, draws):
            before = _launches()
            _synchronize(dev)
            t0 = time.perf_counter()
            loss, stats = fn(batch, draws)
            _synchronize(dev)
            ms = 1e3 * (time.perf_counter() - t0)
            after = _launches()
            state = cpu(model.state_dict())
            rec = {"loss": loss.cpu(),
                   "stats": {k: v.cpu() for k, v in stats.items()},
                   "state": {k: v for k, v in state.items()
                             if k.startswith(stage + ".")},
                   "others_changed": [
                       k for k, v in state.items()
                       if not k.startswith(stage + ".")
                       and not torch.equal(v, payload["state"][k])],
                   "launches": {k: after[k] - before[k] for k in after},
                   "ms": ms}
            if payload.get("adam") or payload.get("eager"):
                rec["adam"] = [cpu(optimizer.state[p]) for g in
                               optimizer.param_groups for p in g["params"]]
            return rec

        steps = []
        for batches, draws in zip(payload["batches"], payload["draws"][stage]):
            b, d = batches[rank], draws[rank]
            eager = None
            if payload.get("eager"):
                held = step_tensors(model, optimizer)
                start = [t.detach().clone() for t in held]
                eager = run(step.eager, b, d)
                with torch.no_grad():
                    for t, s0 in zip(held, start):
                        t.copy_(s0)
            rec = run(step, b, d)
            if eager is not None:
                rec["eager"] = eager
            steps.append(rec)
        out["stages"][stage] = {
            "steps": steps,
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None)}
    return out


def eval_job(payload: Dict[str, Any]) -> Dict[str, Any]:
    """``run_eval`` over the test split of ``payload["cfg"]``'s dataset with
    the model state ``state``, writing under ``log_dir``; pair i's draws
    ``draws[i]`` when the payload has them.  Returns the summary."""
    from buffer_tpu_torch.eval.harness import run_eval
    from buffer_tpu_torch.scripts.test import make_dataset
    dev = rank_device(payload["device"])
    cfg = payload["cfg"]
    draws = payload.get("draws")
    return run_eval(cfg, _model(payload, dev), make_dataset(cfg),
                    log_dir=payload["log_dir"], device=dev,
                    draws_fn=None if draws is None else draws.__getitem__)
