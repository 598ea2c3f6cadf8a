"""Evaluation harness (counterpart of ``buffer_tpu/eval/harness.py``;
reference ``ThreeDMatch/test.py``, ``KITTI/test.py``,
``generalization/*/test.py``): every pair of a dataset through the
compiled registration program (CUDA graphs on the card), Redwood
trajectories written per scene, DGR recall under each dataset's RTE/RRE
thresholds and, for 3DMatch and 3DLoMatch, the covariance-weighted
registration recall against ``gt.info``.

On one device pairs are registered in groups of ``static.pair_unroll``
through :func:`~buffer_tpu_torch.pipeline.registration.
make_unrolled_register_fn` (U pairs' graphs side by side on the card), as
the JAX package compiles U pairs into one program; in a process group of
more than one rank, one pair a rank in rounds (:func:`make_dp_register`,
the JAX package's data parallelism over pairs).  Host prep (dataset IO,
voxelization and ``prepare_pair``) runs on a producer thread (rank 0's) and
yields CPU tensors only; the producer never touches the device (so the
program's capture, on the consumer side, runs in the default global
capture mode).  The copy to the device happens on the consumer side, into
the program's input buffers, and so counts in ``model_time`` (a few MB a
pair), while ``data_time`` is host work alone.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from buffer_tpu_torch import resolve_device
from buffer_tpu_torch.config import Config
from buffer_tpu_torch.data.preprocess import prepare_pair
from buffer_tpu_torch.eval import metrics
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.pipeline.registration import (
    Draws, PairInputs, make_draws, make_register_fn, make_unrolled_register_fn)
from buffer_tpu_torch.utils.dist import group_size
from buffer_tpu_torch.utils.logging import MetricLogger, Timer

# DGR pass thresholds (RTE m, RRE degrees) of each evaluation
THRESHOLDS = {
    "3DMatch": (0.3, 15.0),   # ThreeDMatch/test.py:264-265
    "3DLoMatch": (0.3, 15.0),
    "KITTI": (0.3, 1.0),      # KITTI/test.py:66-67
    "ETH": (0.3, 2.0),        # generalization/ThreeD2ETH/test.py:66-67
}


def _prefetch(cfg: Config, dataset: Sequence, n: int,
              rs: np.random.RandomState, data_timer: Timer, depth: int = 2):
    """Yields (i, item, CPU PairInputs) for the first ``n`` pairs, prepared
    on a producer thread up to ``depth`` pairs ahead (the reference's
    DataLoader workers, ThreeDMatch/dataloader.py:257-264).  ``rs`` is used
    by the pairs in order.  A failure of the producer is raised here; the
    producer stops when the consumer does."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(x) -> None:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return
            except queue.Full:
                continue

    def producer() -> None:
        try:
            for i in range(n):
                if stop.is_set():
                    return
                data_timer.tic()
                item = dataset[i]
                inputs = prepare_pair(cfg, item["src_fds_pts"],
                                      item["tgt_fds_pts"], rs=rs,
                                      already_downsampled=True, device="cpu")
                data_timer.toc()
                put((i, item, inputs))
        except Exception as e:   # handed to the consumer, which raises it
            put(e)
            return
        put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            got = q.get()
            if got is None:
                return
            if isinstance(got, Exception):
                raise got
            yield got
    finally:
        stop.set()
        thread.join()


def run_eval(cfg: Config, model: BufferModel, dataset: Sequence,
             log_dir: Optional[str] = None, max_pairs: Optional[int] = None,
             seed: int = 0, logger: Optional[MetricLogger] = None,
             device=None,
             draws_fn: Optional[Callable[[int], Draws]] = None,
             use_dp: Optional[bool] = None) -> Dict[str, float]:
    """Registers the first ``max_pairs`` pairs of ``dataset`` (all by
    default) with ``model`` (built from ``cfg``, already on ``device``;
    default device: the CUDA card).

    Pair i's random draws come from ``draws_fn(i)`` when given, otherwise
    from one device generator seeded with ``seed``, pair after pair.  On
    one device the pairs go in groups of U = ``cfg.static.pair_unroll`` (1
    for a single pair) through one :func:`make_unrolled_register_fn`
    program built for the model and device (the first group carries
    warm-up and capture, as JAX's first step carries its compile); the
    last group is padded with its last pair, whose result is discarded
    (``buffer_tpu/eval/harness.py:160-177``).  ``model_time`` is the host
    clock around draws + the program's call up to a device synchronize,
    averaged over the groups and divided by U: a time a pair;
    ``data_time`` the producer's host prep a pair.  With ``log_dir``,
    writes each scene's ``est.log`` (inverse poses) and, for 3DMatch and
    3DLoMatch, adds the registration recall.  Returns
    ``recall``, ``TE``, ``RE``, ``data_time``, ``model_time``, ``pairs``
    (and ``registration_recall``).

    In a process group of D > 1 ranks every rank calls ``run_eval`` with
    the same arguments.  With ``use_dp`` (default: D > 1 and n >= D, as the
    JAX package decides from its device count) the pairs go in rounds of
    D, one a rank, through :func:`make_dp_register`: rank 0 runs the
    producer (so ``prepare_pair`` draws from one ``RandomState`` in the
    order of a one-process run) and scatters each round's pairs; the last
    round is padded with its last pair, whose result is discarded.  A rank
    takes pair i's draws as one process would (``draws_fn(i)``, or the
    generator's i-th), so every pose equals a one-process run's on the same
    device.  ``model_time`` is then the host clock around one round,
    scatter to gather, averaged over the rounds: a time a round, not a
    pair.  Rank 0 records and writes ``est.log``; every rank returns rank
    0's summary."""
    dev = resolve_device(device)
    world = group_size()
    rank = dist.get_rank() if world > 1 else 0
    logger = logger or MetricLogger(echo=True)
    rte_th, rre_th = THRESHOLDS[cfg.data.dataset]
    n = len(dataset) if max_pairs is None else min(len(dataset), max_pairs)
    if world > 1:
        n = _broadcast_object(n)
    if use_dp is None:
        use_dp = world > 1 and n >= world
    if use_dp and world < 2:
        raise ValueError("use_dp needs a process group of more than one rank")

    gen = torch.Generator(device=dev).manual_seed(seed)
    drawn: list = [0, None]      # draws made by ``gen`` so far, the last

    def draws_for(i: int) -> Draws:
        if draws_fn is not None:
            return draws_fn(i)
        while drawn[0] <= i:      # other ranks' pairs draw in between
            drawn[1] = make_draws(cfg, gen, dev)
            drawn[0] += 1
        if drawn[0] != i + 1:
            raise RuntimeError(f"pair {i}'s draws were passed over")
        return drawn[1]

    data_timer, model_timer = Timer(), Timer()
    states = []
    entries_by_scene: Dict[str, list] = {}
    rs = np.random.RandomState(cfg.data.manual_seed)

    def record(i, item, pose, num_mutual) -> None:
        pose = pose.cpu().numpy().astype(np.float64)
        gt = np.asarray(item["relt_pose"], np.float64)
        rte, rre = metrics.rte_rre(pose, gt)
        ok = rte < rte_th and rre < rre_th
        states.append([float(ok), rte, rre])
        if not ok:
            logger.log(event="fail", pair=i, rte=rte, rre=rre,
                       mutual=int(num_mutual))
        if log_dir is not None and "/" in item["src_id"]:
            scene = item["src_id"].split("/")[-2]
            sid = item["src_id"].split("/")[-1].split("_")[-1]
            tid = item["tgt_id"].split("/")[-1].split("_")[-1]
            entries_by_scene.setdefault(scene, []).append(
                (sid, tid, np.linalg.inv(pose)))

    def synchronize() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    U = 1
    if not use_dp:
        U = max(1, int(cfg.static.pair_unroll)) if n > 1 else 1
        register = make_unrolled_register_fn(model, U, device=dev)
        for group in _chunks(_prefetch(cfg, dataset, n, rs, data_timer), U):
            batch = group + [group[-1]] * (U - len(group))
            model_timer.tic()
            res = register([inputs for _, _, inputs in batch],
                           [draws_for(i) for i, _, _ in batch])
            synchronize()
            model_timer.toc()
            for j, (i, item, _) in enumerate(group):
                record(i, item, res.pose[j], res.num_mutual[j])
    else:
        dp_fn = make_dp_register(model)
        rounds = ((_chunks(_prefetch(cfg, dataset, n, rs, data_timer), world))
                  if rank == 0 else [None] * (-(-n // world)))
        for batch in rounds:
            model_timer.tic()
            sent = None
            if rank == 0:
                sent = [(i, inputs) for i, _, inputs in batch]
                sent += [sent[-1]] * (world - len(sent))
            got = [None]
            dist.scatter_object_list(got, sent, src=0)
            i, inputs = got[0]
            res = dp_fn(inputs, draws_for(i), device=dev)
            synchronize()
            model_timer.toc()
            if rank == 0:
                for j, (i, item, _) in enumerate(batch):
                    record(i, item, res.pose[j], res.num_mutual[j])

    out = None
    if rank == 0:
        out = metrics.dgr_recall(np.array(states).reshape(-1, 3))
        out["data_time"] = data_timer.avg
        out["model_time"] = model_timer.avg / U
        out["pairs"] = len(states)
        if log_dir is not None:
            for scene, entries in entries_by_scene.items():
                metrics.write_trajectory(
                    os.path.join(log_dir, scene, "est.log"), entries)
            if cfg.data.dataset in ("3DMatch", "3DLoMatch"):
                rr = registration_recall(cfg, log_dir)
                if rr is not None:
                    out["registration_recall"] = rr
        logger.log(event="summary", dataset=cfg.data.dataset, **out)
    return _broadcast_object(out) if world > 1 else out


def _chunks(items, size: int):
    """Lists of ``size`` consecutive items (the last may be shorter)."""
    batch = []
    for x in items:
        batch.append(x)
        if len(batch) == size:
            yield batch
            batch = []
    if batch:
        yield batch


def _broadcast_object(obj):
    """``obj`` of rank 0, on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class DPResult(NamedTuple):
    pose: torch.Tensor         # [D, 4, 4] src -> tgt, by rank
    num_mutual: torch.Tensor   # [D] int64


def make_dp_register(model: BufferModel, group=None):
    """Data-parallel registration (``buffer_tpu/eval/harness.py:245-268``):
    returns ``fn(inputs, draws, device=None) -> DPResult`` that registers
    this rank's pair of ``group`` (default: the default group) with its own
    draws, every rank calling it once a round, and all-gathers the poses
    and ``num_mutual``, so that every rank holds the round's results with a
    leading D axis (rank r's pair at r).  A rank registers through its own
    :func:`make_register_fn` program, one for each device it is asked
    for."""
    world = group_size(group)
    programs = {}

    def fn(inputs: PairInputs, draws: Draws, device=None) -> DPResult:
        dev = resolve_device(device)
        if dev not in programs:
            programs[dev] = make_register_fn(model, device=dev)
        res = programs[dev](inputs, draws)
        mutual = res.num_mutual.reshape(1)
        poses = [torch.empty_like(res.pose) for _ in range(world)]
        mutuals = [torch.empty_like(mutual) for _ in range(world)]
        dist.all_gather(poses, res.pose.contiguous(), group=group)
        dist.all_gather(mutuals, mutual, group=group)
        return DPResult(torch.stack(poses), torch.cat(mutuals))

    return fn


def registration_recall(cfg: Config, log_dir: str) -> Optional[float]:
    """Scene-averaged Redwood registration recall of the ``est.log`` files
    under ``log_dir`` (ThreeDMatch/test.py:287-308); None without gt."""
    if cfg.data.dataset == "3DMatch":
        gtroot = os.path.join(cfg.data.root, "test", "3DMatch", "gt_result")
    else:
        gtroot = os.path.join(cfg.data.root, "test", "3DLoMatch")
    if not os.path.isdir(gtroot):
        return None
    recalls = []
    for scene in sorted(os.listdir(gtroot)):
        gt_pairs, gt_traj = metrics.read_trajectory(
            os.path.join(gtroot, scene, "gt.log"))
        n_frag, cov = metrics.read_trajectory_info(
            os.path.join(gtroot, scene, "gt.info"))
        est_path = os.path.join(log_dir, scene, "est.log")
        if not os.path.exists(est_path):
            continue
        est_pairs, est_traj = metrics.read_trajectory(est_path)
        _, rec = metrics.evaluate_registration(
            n_frag, est_traj, est_pairs.astype(float).astype(int),
            gt_pairs.astype(float).astype(int), gt_traj, cov)
        recalls.append(rec)
    return float(np.mean(recalls)) if recalls else None
