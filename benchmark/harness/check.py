"""The output check that decides ``correct``: the program's outputs of the
checked requests against the plain reference's (:mod:`benchmark.reference`:
NumPy host prep and BUFFER in float64), computed after the window on the
same raw clouds and draws, from the weights that the benchmark made.  The
reference takes nothing that the program made.  Each compared number is
the worst over the checked requests, unless named otherwise:

- ``prep_err``: the largest coordinate gap of the prepared pair (raw,
  level-0, level-1 and level-2 clouds), 1e9 where a mask differs (host
  prep: voxel grids, shuffles, caps, Morton order, padding);
- ``kpt_miss``: the share (%) of one side's valid keypoints of a cloud
  that are not among the other side's, the larger way round (pyramid and
  banded neighbourhoods, normals, EFCNN, DetNet saliency, the threshold
  and FPS); another pair's keypoints read ~100;
- ``mutual_mean``: the gap in the count of mutual matches (patches, the
  SPT, MiniSpinNet, mutual matching), averaged over the checked requests
  (``mutual_diff``: the largest);
- ``inlier_diff``: the gap in RANSAC's inlier count (cost volume, votes,
  RANSAC);
- ``pose_err``: the largest entry gap of the final pose (IRLS);
  ``pose_same``: the same over the requests whose mutual and inlier
  counts equal the reference's (with random weights RANSAC picks among a
  handful of vote inliers, so a count one side off sends the pose
  elsewhere: rounding, not a fault);
- ``missing``: checked requests with no answer.

A run is correct when every number that the configuration file's
``limits`` names is within its limit.
"""

from __future__ import annotations

import numpy as np
import torch

BAD = 1e9
NUMBERS = ("prep_err", "kpt_miss", "mutual_mean", "mutual_diff", "inlier_diff",
           "pose_err", "pose_same", "missing")
SAME_POINT = 1e-4    # m: keypoints are points of the same level-0 cloud


def prep_gap(program, ref: dict) -> float:
    worst = 0.0
    for k, v in ref.items():
        got = getattr(program, k).detach().cpu().numpy()
        if k.endswith("mask"):
            if not np.array_equal(got, v):
                return BAD
        else:
            worst = max(worst, float(np.max(np.abs(got - v))))
    return worst


def kpt_miss(prog: dict, ref: dict) -> float:
    worst = 0.0
    for b in range(prog["kpts"].shape[0]):
        p = prog["kpts"][b][prog["kpt_valid"][b].bool()].double()
        r = ref["kpts"][b][ref["kpt_valid"][b].bool()].double()
        if not len(p) or not len(r):
            miss = 0.0 if len(p) == len(r) else 100.0
        else:
            d = torch.cdist(p, r)
            lost = max(int((d.amin(1) > SAME_POINT).sum()),
                       int((d.amin(0) > SAME_POINT).sum()))
            miss = 100.0 * lost / len(r)
        worst = max(worst, miss)
    return worst


def output_gaps(prog: dict, ref: dict) -> dict:
    return {"kpt_miss": kpt_miss(prog, ref),
            "mutual_diff": float(abs(int(prog["num_mutual"])
                                     - int(ref["num_mutual"]))),
            "inlier_diff": float(abs(int(prog["num_inliers"])
                                     - int(ref["num_inliers"]))),
            "pose_err": float((prog["pose"].double()
                               - ref["pose"].double()).abs().max())}


class Reference:
    """The plain reference with the benchmark's weights on ``device``, and
    its answers by request, each computed once."""

    def __init__(self, conf: dict, state: dict, device, traffic,
                 precision: str = "fp64"):
        from benchmark.reference import buffer
        self.buffer = buffer
        self.model = buffer.Reference(conf, state, device, precision)
        self.traffic = traffic
        self.answers, self.preps = {}, {}

    def prepare(self, request: int) -> dict:
        """The reference's prep of the request's pool pair, with its draws."""
        from benchmark.reference import prep
        if request not in self.preps:
            t = self.traffic
            j = t.pair_of(request)
            raw = t.raw_pair(j)
            self.preps[request] = prep.prepare_pair(
                self.model.s, raw.src.copy(), raw.tgt.copy(), t.prep_state(j),
                t.mix["already_downsampled"])
        return self.preps[request]

    def answer(self, request: int) -> dict:
        if request not in self.answers:
            draws = self.traffic.draws(self.model.s, request, self.model.dev,
                                       self.buffer.Draws)
            self.answers[request] = self.model.register(self.prepare(request),
                                                        draws)
        return self.answers[request]


def compare(reference: Reference, requests, outputs: dict,
            programs_prep, detail: dict = None) -> dict:
    """The worst of each number over ``requests``.  ``outputs``: the
    answers by request; ``programs_prep(request)``: the program's prepared
    pair of the request; ``detail``, when given, gets each request's
    gaps."""
    worst = {k: 0.0 for k in NUMBERS}
    answered = 0
    for r in requests:
        if r not in outputs:
            worst["missing"] += 1
            continue
        worst["prep_err"] = max(worst["prep_err"],
                                prep_gap(programs_prep(r), reference.prepare(r)))
        gaps = output_gaps(outputs[r], reference.answer(r))
        if detail is not None:
            ref = reference.answer(r)
            detail[r] = dict(gaps, mutual=[int(outputs[r]["num_mutual"]),
                                           int(ref["num_mutual"])],
                             inliers=[int(outputs[r]["num_inliers"]),
                                      int(ref["num_inliers"])],
                             ref_moved=float((ref["pose"].double() - torch.eye(
                                 4, dtype=torch.float64)).abs().max()))
        for k, v in gaps.items():
            worst[k] = max(worst[k], v)
        if gaps["mutual_diff"] == 0 and gaps["inlier_diff"] == 0:
            worst["pose_same"] = max(worst["pose_same"], gaps["pose_err"])
        worst["mutual_mean"] += gaps["mutual_diff"]
        answered += 1
    worst["mutual_mean"] /= max(answered, 1)
    return worst


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {value, limit}}) over the numbers that ``limits``
    names (a configuration compares those that separate its control from
    sound runs); no limits at all is not correct."""
    table = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    ok = bool(table) and all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
