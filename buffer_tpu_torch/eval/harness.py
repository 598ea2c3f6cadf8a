"""Evaluation harness (counterpart of ``buffer_tpu/eval/harness.py``;
reference ``ThreeDMatch/test.py``, ``KITTI/test.py``,
``generalization/*/test.py``): every pair of a dataset through
:func:`~buffer_tpu_torch.pipeline.registration.register_pair`, Redwood
trajectories written per scene, DGR recall under each dataset's RTE/RRE
thresholds and, for 3DMatch and 3DLoMatch, the covariance-weighted
registration recall against ``gt.info``.

Pairs are registered one at a time on the device.  Host prep (dataset IO,
voxelization and ``prepare_pair``) runs on a producer thread and yields CPU
tensors only; the producer never touches the device.  The copy to the
device happens on the consumer side, inside ``register_pair``, and so
counts in ``model_time`` (a few MB a pair), while ``data_time`` is host
work alone.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from buffer_tpu_torch import resolve_device
from buffer_tpu_torch.config import Config
from buffer_tpu_torch.data.preprocess import prepare_pair
from buffer_tpu_torch.eval import metrics
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.pipeline.registration import (Draws, make_draws,
                                                    register_pair)
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
             draws_fn: Optional[Callable[[int], Draws]] = None
             ) -> Dict[str, float]:
    """Registers the first ``max_pairs`` pairs of ``dataset`` (all by
    default) with ``model`` (built from ``cfg``, already on ``device``;
    default device: the CUDA card).

    Pair i's random draws come from ``draws_fn(i)`` when given, otherwise
    from one device generator seeded with ``seed``, pair after pair.
    ``model_time`` is the host clock around draws + ``register_pair`` up to
    a device synchronize, averaged over the pairs registered; ``data_time``
    the producer's host prep a pair.  With ``log_dir``, writes each scene's
    ``est.log`` (inverse poses) and, for 3DMatch and 3DLoMatch, adds the
    registration recall.  Returns ``recall``, ``TE``, ``RE``,
    ``data_time``, ``model_time``, ``pairs`` (and ``registration_recall``)."""
    dev = resolve_device(device)
    logger = logger or MetricLogger(echo=True)
    rte_th, rre_th = THRESHOLDS[cfg.data.dataset]
    n = len(dataset) if max_pairs is None else min(len(dataset), max_pairs)

    gen = torch.Generator(device=dev).manual_seed(seed)
    data_timer, model_timer = Timer(), Timer()
    states = []
    entries_by_scene: Dict[str, list] = {}
    rs = np.random.RandomState(cfg.data.manual_seed)

    for i, item, inputs in _prefetch(cfg, dataset, n, rs, data_timer):
        model_timer.tic()
        draws = draws_fn(i) if draws_fn is not None else make_draws(cfg, gen, dev)
        res = register_pair(model, inputs, draws, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        model_timer.toc()

        pose = res.pose.cpu().numpy().astype(np.float64)
        gt = np.asarray(item["relt_pose"], np.float64)
        rte, rre = metrics.rte_rre(pose, gt)
        ok = rte < rte_th and rre < rre_th
        states.append([float(ok), rte, rre])
        if not ok:
            logger.log(event="fail", pair=i, rte=rte, rre=rre,
                       mutual=int(res.num_mutual))
        if log_dir is not None and "/" in item["src_id"]:
            scene = item["src_id"].split("/")[-2]
            sid = item["src_id"].split("/")[-1].split("_")[-1]
            tid = item["tgt_id"].split("/")[-1].split("_")[-1]
            entries_by_scene.setdefault(scene, []).append(
                (sid, tid, np.linalg.inv(pose)))

    out = metrics.dgr_recall(np.array(states).reshape(-1, 3))
    out["data_time"] = data_timer.avg
    out["model_time"] = model_timer.avg
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
    return out


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
