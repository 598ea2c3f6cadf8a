"""Per-stage device time of one registration on the card (counterpart of
the repository's ``scripts/profile_stages.py``):

    python -m buffer_tpu_torch.scripts.profile_stages --config {3DMatch,KITTI}
        [--torch-weights DIR]

The pair is the JAX script's: bench.py's pair
(:func:`~buffer_tpu_torch.data.synthetic.bench_pair`, seed 0) for 3DMatch,
:func:`~buffer_tpu_torch.data.synthetic.lidar_pair` (seed 13) for KITTI,
at the preset's full static plan, with draws from a generator
seeded 0 and seeded random weights (``BufferModel(cfg, seed=0)``) or a
reference snapshot (``--torch-weights``).  Everything runs under
``full_fp32()``.

The rows (:func:`stage_bodies`) split ``pair_front`` and ``pair_tail`` into
their parts, each the port's own code run on what the rows before it
produced: pyramid + normals, EFCNN (Ref), DetNet (Keypt), threshold + FPS,
MiniSpinNet (both clouds in one batch of 2K patches, where the JAX script
times one cloud and says it runs twice), mutual matching, the cost volume
(at the full keypoint count whatever the mutual count), hypotheses +
voting, then RANSAC and (where the preset refines) IRLS as a row each for
the base budget and, where the preset has it, the low-match one.  Each row is timed by
:func:`~buffer_tpu_torch.utils.profiling.graph_time` (a CUDA graph of the
row, replays differenced).  Before timing the rows are chained once more and
held bit-equal to the eager ``register_pair`` (intermediates, pose and
RANSAC inliers of the budget it takes) and to ``pair_tail`` of the other
budget; a difference raises.

Prints one JSON line: the card (name, power limit), each row's ms, the sum
of the front rows and the taken budget's tail rows beside the device ms of
a ``make_register_fn`` replay on the same pair and draws (CUDA events), the
tail the pair takes, each pose-solver call of the taken tail
(``kabsch_cuda``: RANSAC's hypotheses and refit; ``irls_cuda``: every IRLS
round) with its shape, count and ms, and the kernels' launches over one
pass of the rows.  Runs on the CUDA card only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch


class Row(NamedTuple):
    """A profile row: its name, the body that runs it (a closure over fixed
    input tensors that returns tensors) and its floating-point operations
    where counted (None otherwise)."""

    name: str
    body: Callable
    flops: Optional[int] = None


def budget_name(boost: bool) -> str:
    return "boost" if boost else "base"


def profile_pair(cfg, dev):
    """(PairInputs, ground truth T [4, 4], draws) of the profiled pair of
    ``cfg``'s dataset on ``dev``: bench.py's pairs, as the JAX scripts
    take them (``bench_pair`` seed 0, ``lidar_pair`` seed 13), with draws
    from a generator seeded 0."""
    from buffer_tpu_torch.data.synthetic import bench_pair, lidar_pair
    from buffer_tpu_torch.pipeline.registration import make_draws
    if cfg.data.dataset == "KITTI":
        inputs, T = lidar_pair(cfg, 13, dev)
    else:
        inputs, T = bench_pair(cfg, dev)
    draws = make_draws(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    return inputs, T, draws


def bench_model(cfg, torch_weights: Optional[str], dev):
    """A reference snapshot's model (``torch_weights``) or seeded random
    weights, on ``dev`` in eval mode; and what the weights are."""
    if torch_weights:
        from buffer_tpu_torch.scripts.test import load_model
        return load_model(cfg, None, torch_weights, dev).eval(), torch_weights
    from buffer_tpu_torch.models.composite import BufferModel
    return BufferModel(cfg, seed=0).to(dev).eval(), "random, seed 0"


def stage_bodies(model, inputs, draws, boost: Sequence[bool] = (False,)
                 ) -> List[Row]:
    """The rows of one registration, in pipeline order, each run once here
    on the outputs of the rows before it.  ``boost``: the budgets
    (``tail_budget``'s flag) whose RANSAC and (with ``test.pose_refine``)
    IRLS rows end the list.
    Call under ``torch.no_grad()`` and ``full_fp32()``."""
    from buffer_tpu_torch.pipeline import registration as reg
    from buffer_tpu_torch.pipeline.pyramid import build_pyramid_and_normals
    cfg = model.cfg
    rows: List[Row] = []

    def row(name, body):
        rows.append(Row(name, body))
        return body()

    levels = (None if inputs.lvl1 is None else
              (inputs.lvl1, inputs.lvl1_mask, inputs.lvl2, inputs.lvl2_mask))
    pyr = row("pyramid + normals", lambda: build_pyramid_and_normals(
        cfg, inputs.sds, inputs.sds_mask, levels))
    axis, _, branch = row("EFCNN (Ref)",
                          lambda: reg.reference_axes(model, pyr, inputs.sds))
    score = row("DetNet (Keypt)", lambda: model.Keypt(pyr, branch)[..., 0])
    _, kvalid, kpts, kaxes = row("threshold + FPS", lambda: reg.detect_keypoints(
        cfg, inputs.sds, inputs.sds_mask, score, axis))
    (s_des, s_equi, s_R), (t_des, t_equi, t_R) = row(
        "MiniSpinNet (both clouds)", lambda: reg.describe_both(
            model, cfg, draws, inputs.raw, inputs.raw_mask, kpts, kaxes))
    m, tgt, tt_kpts, tt_R, num_mutual = row(
        "mutual matching",
        lambda: reg.match_keypoints(kpts, kvalid, s_des, t_des, t_R))
    ind = row("cost volume", lambda: reg.cost_volume(model, s_equi, t_equi, tgt))
    *_, vote_inliers = row("hypotheses + voting", lambda: reg.vote(
        cfg, kpts[0], tt_kpts, s_R, tt_R, ind, m.mutual))
    front = reg.Front(ss_kpts=kpts[0], tt_kpts=tt_kpts, mutual=m.mutual,
                      vote_inliers=vote_inliers, num_mutual=num_mutual,
                      kpts=kpts, kpt_valid=kvalid)
    for b in boost:
        gumbel, iters = reg.tail_budget(cfg, draws, b)
        pose, _ = row(f"RANSAC ({budget_name(b)})",
                      lambda g=gumbel: reg.tail_ransac(cfg, front, g))
        if cfg.test.pose_refine:
            row(f"IRLS ({budget_name(b)})",
                lambda p=pose, n=iters: reg.tail_refine(cfg, front, p, n))
    return rows


def chain_results(rows: Sequence[Row]):
    """Calls each row's body once, in order; returns (what the rows give,
    under ``register_pair``'s intermediate names, and for each budget its
    (pose, number of RANSAC inliers))."""
    out = {r.name: r.body() for r in rows}
    axis, eps, _ = out["EFCNN (Ref)"]
    kidx, kvalid, kpts, kaxes = out["threshold + FPS"]
    (s_des, s_equi, s_R), (t_des, t_equi, t_R) = out["MiniSpinNet (both clouds)"]
    m = out["mutual matching"][0]
    R_h, t_h, best, vote_inliers = out["hypotheses + voting"]
    inter = {"pyramid": out["pyramid + normals"], "axis": axis, "eps": eps,
             "score": out["DetNet (Keypt)"], "kidx": kidx, "kvalid": kvalid,
             "kpts": kpts, "kaxes": kaxes, "s_des": s_des, "t_des": t_des,
             "s_equi": s_equi, "t_equi": t_equi, "s_R": s_R, "t_R": t_R,
             "matches": m, "azi_ind": out["cost volume"], "best_hyp": best,
             "vote_inliers": vote_inliers, "R_h": R_h, "t_h": t_h}
    tails = {}
    for b in (False, True):
        if f"RANSAC ({budget_name(b)})" in out:
            pose, inl = out[f"RANSAC ({budget_name(b)})"]
            tails[b] = (out.get(f"IRLS ({budget_name(b)})", pose), torch.sum(inl))
    return inter, tails


def _leaves(x):
    return torch.utils._pytree.tree_leaves(x)


def chain_mismatches(model, inputs, draws, chained, dev) -> list:
    """What the chained rows (:func:`chain_results`) give differently from
    the eager pair: each intermediate against ``register_pair``'s, the
    taken budget's pose and inlier count against its result, every other
    budget's against ``pair_tail`` on the eager front.  Returns the
    differing names."""
    from buffer_tpu_torch.pipeline import registration as reg
    inter, tails = chained
    res, want = reg.register_pair(model, inputs, draws, device=dev,
                                  return_intermediates=True)
    with torch.no_grad(), reg.full_fp32():
        front, _ = reg.pair_front(model, inputs, draws)
    taken = reg.boost_taken(model.cfg, res.num_mutual)
    bad = [k for k in want
           if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                      zip(_leaves(inter[k]), _leaves(want[k])))]
    for b, (pose, n_inl) in tails.items():
        if b == taken:
            ok = torch.equal(pose, res.pose) and torch.equal(n_inl, res.num_inliers)
        else:
            with torch.no_grad(), reg.full_fp32():
                w_pose, w_inl = reg.pair_tail(model.cfg, front,
                                              *reg.tail_budget(model.cfg, draws, b))
            ok = torch.equal(pose, w_pose) and torch.equal(n_inl, w_inl)
        if not ok:
            bad.append(f"pose ({budget_name(b)})")
    if taken not in tails:
        bad.append(f"no rows of the taken budget ({budget_name(taken)})")
    return bad


@contextlib.contextmanager
def recorded(mod, name: str, calls: list):
    """Within the block every call of ``mod.name`` is appended to ``calls``
    as (args, kwargs) and then made."""
    fn = getattr(mod, name)

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(mod, name, record)
    try:
        yield
    finally:
        setattr(mod, name, fn)


def pose_calls(rows: Sequence[Row], budget: str) -> list:
    """Each distinct pose-solver call of ``budget``'s RANSAC and IRLS rows
    (one eager pass): the row, the wrapper (``kabsch_cuda``, ``irls_cuda``),
    the shape of its points, whether weighted (Kabsch) or its rounds
    (IRLS), how often the row makes it, and the recorded arguments."""
    from buffer_tpu_torch.pipeline import ransac, refine
    out = []
    for r in rows:
        if not r.name.endswith(f"({budget})"):
            continue
        calls = {"kabsch_cuda": [], "irls_cuda": []}
        with recorded(ransac, "kabsch_cuda", calls["kabsch_cuda"]), \
                recorded(refine, "irls_cuda", calls["irls_cuda"]):
            r.body()
        kinds = {}
        for wrapper, made in calls.items():
            for args, kwargs in made:
                if wrapper == "kabsch_cuda":
                    w = args[2] if len(args) > 2 else kwargs.get("weights")
                    how = {"weighted": w is not None}
                else:
                    how = {"rounds": args[5]}
                key = (wrapper, tuple(args[1].shape), *how.values())
                if key not in kinds:
                    kinds[key] = {"row": r.name, "wrapper": wrapper,
                                  "points": list(args[1].shape), **how,
                                  "calls": 0, "args": (args, kwargs)}
                kinds[key]["calls"] += 1
        out += list(kinds.values())
    return out


def replay_device_ms(fn, inputs, draws, reps: int = 3) -> float:
    """The least device ms of ``reps`` calls of a warmed compiled program,
    each between two CUDA events."""
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(inputs, draws)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def run(cfg, model, inputs, draws, dev) -> dict:
    """The profile of one pair (see the module's docstring) as a dict."""
    from buffer_tpu_torch.kernels import cuda, pose_cuda
    from buffer_tpu_torch.pipeline import registration as reg
    from buffer_tpu_torch.utils.profiling import graph_time
    budgets = (False, True) if cfg.static.low_match_boost else (False,)
    with torch.no_grad(), reg.full_fp32():
        rows = stage_bodies(model, inputs, draws, budgets)
        cuda.reset_launches()
        chained = chain_results(rows)
        launches = {k: n for k, n in cuda.launch_counts().items() if n}
        bad = chain_mismatches(model, inputs, draws, chained, dev)
        if bad:
            raise RuntimeError(f"profile_stages: the chained rows differ from "
                               f"the eager pair in {bad}")
        num_mutual = torch.sum(chained[0]["matches"].mutual)
        taken = budget_name(reg.boost_taken(cfg, num_mutual))
        solves = pose_calls(rows, taken)
        for k in solves:
            args, kwargs = k.pop("args")
            wrapper = getattr(pose_cuda, k["wrapper"])
            k["ms_a_call"] = graph_time(lambda f=wrapper, a=args, kw=kwargs:
                                        f(*a, **kw))
        timed = [{"name": r.name, "ms": graph_time(r.body)} for r in rows]
    fn = reg.make_register_fn(model, device=dev)
    fn(inputs, draws)
    replay_ms = replay_device_ms(fn, inputs, draws)
    front_rows = [t["ms"] for t in timed
                  if not t["name"].endswith(("(base)", "(boost)"))]
    tail_rows = [t["ms"] for t in timed if t["name"].endswith(f"({taken})")]
    sum_ms = sum(front_rows) + sum(tail_rows)
    return {"config": cfg.data.dataset, "rows": timed,
            "sum_ms": sum_ms, "replay_device_ms": replay_ms,
            "sum_over_replay": sum_ms / replay_ms,
            "tail_taken": taken, "num_mutual": int(num_mutual),
            "pose_calls": solves,
            "pose_ms": sum(k["ms_a_call"] * k["calls"] for k in solves),
            "chain_bit_equal": True, "launches_a_pass": launches,
            "notes": ["MiniSpinNet: both clouds in one batch of 2K patches "
                      "(the JAX script's row is one cloud, run twice)",
                      "sum_ms: the front rows and the taken tail's rows"]}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m buffer_tpu_torch.scripts.profile_stages")
    ap.add_argument("--config", default="3DMatch", choices=("3DMatch", "KITTI"))
    ap.add_argument("--torch-weights", default=None,
                    help="reference snapshot directory with <stage>/best.pth "
                         "(default: seeded random weights)")
    args = ap.parse_args(argv)

    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.config import make_cfg
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.utils.profiling import card_line

    dev = resolve_device(None)
    cuda.build_all()
    cfg = make_cfg(args.config)
    model, weights = bench_model(cfg, args.torch_weights, dev)
    inputs, _, draws = profile_pair(cfg, dev)
    out = run(cfg, model, inputs, draws, dev)
    print(json.dumps({"card": card_line(), "weights": weights, **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
