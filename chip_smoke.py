#!/usr/bin/env python3
"""Smoke test of buffer_tpu_torch on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds every
   CUDA kernel from ``buffer_tpu_torch/csrc`` (one nvcc per library, all
   started together).
2. Drives twenty-four paths, each with every kernel launch counter set to 0
   just before it and read just after (in each rank's own process for the
   data-parallel ones); every kernel of a path must have run on every pair
   (or step) of it, as often as the path's table says:
   * the main path: ``register_pair`` on the shipped 3DMatch preset
     (``knn_band = 4096``) at full width -- 30720/10240/3072 pyramid points,
     65536 raw points, 1500 keypoints, 512-point patches, 1024 RANSAC
     hypotheses with the x4 low-match boost -- on 3 synthetic fragment pairs
     (the surface generator of bench.py) with seeded random weights;
   * the KITTI preset at full width (40960/20480/6144 pyramid points,
     131072 raw points) on 2 synthetic LiDAR pairs, the first a warm-up;
   * the 3DMatch preset with ``knn_band = 0`` (exact unbanded search) on
     1 pair;
   * the 3DMatch preset with ``fused_desc = False`` (the reference's
     sampled descriptor front: stacked patches through
     ``ball_sample_points``, the sampled SPT, the network on the sampled
     patches) on the main path's first 2 pairs, the first a warm-up;
   * the single-cloud FPS entry point ``ops.sampling.farthest_point_sample``
     on the main path's first source cloud;
   * "3DMatch program" and "KITTI program": the compiled registration
     program (``pipeline.registration.make_register_fn``, CUDA graphs of
     the front and of each RANSAC/IRLS tail) on the main path's 3 pairs and
     the KITTI path's 2, with their draws, twice (the first pass warms and
     captures, the second replays): every call launches the path's table,
     every result bit-equal to ``register_pair``'s and unchanged by the
     calls after it, one replay profiled (``torch.profiler``: each kernel's
     ``__global__`` names as often as its counter rose); warm ms/pair of
     the program and of ``register_pair`` side by side (6 calls each),
     capture seconds, host dispatches a pair, device ms of a replay.  Then
     one 3DMatch pair each through programs of the boost tail
     (``low_match_th`` above any count), the base tail, ``fused_desc =
     False`` and device levels, each replay bit-equal to its eager pair;
     weights loaded in place replay, a replaced parameter raises;
   * "unrolled": the unrolled program (``pipeline.registration.
     make_unrolled_register_fn``, U pairs' graph chains on streams of their
     own) on the main path's 3 pairs at U = 1, 2 and 3 and the KITTI
     path's 2 at U = 1 and 2, groups padded as ``run_eval`` pads, two
     passes each: every pair of every call bit-equal to ``register_pair``
     (so to ``make_register_fn``), every call launching U times the path's
     table with one host synchronization (replays), a stream and a memory
     pool a chain; then the 3 pairs at U = 3 with ``low_match_th`` between
     their mutual counts (one group, both tails).  Prints ms/pair (host
     clock, 6 calls), device ms a call (CUDA events) against U times U =
     1's, capture seconds and memory at each U;
   * "bench": the benchmark entry point (``buffer_tpu_torch.bench.main``)
     on 3DMatch and KITTI at full size (``bench_path``): bench.py's pairs
     and pairs a call (3DMatch 3 unrolled, KITTI 1), seeded random
     weights, the program's first call then 3 runs of 2 and of 12 calls
     differenced, and one run of 12 between CUDA events.  Its one JSON
     line is printed; each pair of its last timed call (pose, mutual
     count, every field) bit-equal to ``register_pair`` on the bench's
     pair rebuilt here with that pair's draws; a timed replay launching
     the preset's table a pair (every call of the run too); ``value``
     finite and above 0 and ``1000 / value`` equal to ``ms_per_pair`` to
     their rounding; its ms/pair printed beside the program line's (other
     pairs: not gated);
   * "profiles": the measurement entry points through their ``main(argv)``
     at full width (``profiles_path``): ``scripts.profile_stages`` on
     3DMatch and KITTI (each stage's rows, chained, bit-equal to
     ``register_pair``'s intermediates and pose for both budgets, their one
     pass launching the path's table, each row's ms by a CUDA graph's
     differenced replays beside the program's replay), ``profile_micro``
     on 3DMatch (the per-layer rows bit-equal to ``model.Ref``,
     ``model.Keypt``, ``describe_both`` and both networks), ``profile_train``
     on the four stages with the TF32 precision check, ``capture_trace``
     then ``analyze_trace``, whose depth-1 ms an iteration must lie within
     5% of a profiled replay's kernel ms; every row finite and above 0;
   * "3DMatch train": stage-sequential training at the same full width
     (``pos_num = 512`` positive pairs a step, 512-point patches, 420 SPT
     anchors, ``voxel_sample = 10``) on the main path's first 2 pairs with
     their ground-truth poses: one ``Trainer`` per stage, Ref -> Desc ->
     Keypt -> Inlier, the others frozen, 3 train steps (the first a
     warm-up) and 1 eval step each, through the compiled steps.  Every
     step's launches must equal ``TRAIN_STEP``; losses finite; only the
     active stage's parameters move, the frozen stages' running statistics
     stay; the best and epoch checkpoints reload equal.
   * "3DMatch train program" and "KITTI train program": the compiled
     training steps (``train.trainer.make_train_step`` /
     ``make_eval_step``, a CUDA graph a step) stage after stage on the main
     path's first 2 pairs and the KITTI path's 2 (``train_program_path``):
     under deterministic algorithms 4 steps a stage (capture, replay,
     replay after ``set_epoch_lr``, replay with a NaN pose, which Ref
     skips) bit-equal to eager steps of a twin model (loss, stats,
     parameters, running statistics, Adam's state) and 2 eval calls
     bit-equal to ``eval_step``; in default mode the replay within 1e-5
     (loss) and 2 lr (parameters) of an eager step from the same state,
     beside two eager steps' own spread; program and eager ms/step (6
     each), first-call ms,
     capture s, host dispatches and device ms of a replay, a profiled
     replay's ``__global__`` names, peak memory; a replaced parameter
     raises.  Then ``make_optimizer``'s capturable Adam against the
     float-rate Adam on equal gradients (1e-3 lr).
   * "eval": the evaluation path through the test entry point
     (``buffer_tpu_torch.scripts.test.main``) at the shipped presets' full
     static plans, on dataset trees the script writes into
     ``build/eval_smoke/``: a 3DMatch test tree (one scene, 4 fragments of
     bench.py's wavy surface in local frames, >= 40000 points each after
     the loader's 2 cm downsample, 3 gt pairs with ``gt.log``/``gt.info``)
     and a KITTI sequence 08 (5 LiDAR scans of ``lidar_scene``, 9.5 m apart,
     which the loader's pair mining turns into 2 pairs, ground truth refined
     by ICP).  Each tree runs with seeded random weights written as a
     reference snapshot (``--torch-weights``), and the 3DMatch tree also
     with the checkpoints of "3DMatch train" (``--weights``); the harness
     registers the 3DMatch tree's 3 pairs as one group of its
     ``pair_unroll = 3`` and KITTI's one at a time, through its
     ``make_unrolled_register_fn`` program.  Every pair must be in a group
     of the preset's size and launch the path's kernels (counts read
     around each call, a group's over its pairs); the
     loaded model must equal the files; every pair's result (the first
     group the program's warm-up, the others replays) must equal
     ``register_pair``
     on the same inputs and draws bit for bit;
     ``est.log`` must read back as the inverse poses (1e-6); recall, TE,
     RE and pairs must match the per-pair records, the registration recall
     lie in [0, 1].  Prints a line per run with the harness's model and
     data ms/pair.
   * "3DMatch device levels": the main path's first pair with
     ``lvl1 = None`` (levels 1 and 2 voxel-subsampled on the card), twice:
     the levels equal ``prepare_pair``'s as point sets (1e-5, equal
     counts), the plain path agrees, the banded searches over them are
     checked bit-equal and scored; the pyramid span beside the host's;
   * "train entry 3DMatch" and "train entry KITTI":
     ``buffer_tpu_torch.scripts.train.main`` at the presets' full width over
     training trees written into ``build/train_entry/`` (KITTI's ICP cached
     first), every stage 1 epoch of 3 steps and its val split: every step's
     launches as ``STEP_LAUNCHES``, losses finite, no step skipped, only the
     active stage moves, ``best.pth`` and a val line for every stage; ms/step
     and peak memory a stage; one KITTI Ref step against its plain twin;
   * "presets": the test entry point at full width, one pair each, with a
     seeded reference snapshot: ThreeD2ETH over an ETH tree written here,
     KITTI2ThreeD over the eval 3DMatch tree's 3DLoMatch pair, ThreeD2KITTI
     over the eval KITTI tree (its level-1 overflow warning required), with
     the eval path's gates;
   * "train_then_register": ``scripts.train_then_register.main`` at 8 train
     pairs, 1 epoch, 4 held-out pairs (a plumbing gate, no recall bar):
     every held-out pair's launches as small_cfg's table, the record
     written, recall and diagnosis finite.
   * "dp register 3DMatch": ``make_dp_register`` over the main path's 3
     pairs and draws with ranks started as fresh interpreters
     (``utils/dist.launch``): world 2 on the one card over gloo (NCCL
     refuses two ranks on a device), 2 rounds, the second padded; world 1
     over gloo; world 1 over NCCL.  Each rank's launches around each pair
     as the main path's table; every pose and mutual count bit-equal to
     the main path's one-process ``register_pair`` and equal on every
     rank; pairs/s at world 1 and 2 (``utils/dp_scaling.measure``).
   * "dp train 3DMatch" and "dp train program": ``make_dp_train_step``
     (two CUDA graphs around the eager all-reduce) at world 2 (gloo) for
     Ref and Desc on the main path's first 2 pairs, 3 steps each (the
     first the warm-up and capture), under deterministic algorithms: each
     step bit-equal to the eager DP step from the same state on every rank
     (``step.eager``, run first and rolled back), parameters bit-equal
     across ranks and within 1e-6 of one process's step on the mean
     gradient (loss 1e-5), running statistics the mean of the one-pair
     updates, only the active stage moves, every step's launches as
     ``TRAIN_STEP``; program and eager ms/step and peak memory a rank.
   * "dp eval 3DMatch": the test entry point as 2 ranks with the
     ``torchrun`` variables (``--dist-backend gloo``) over the eval path's
     3DMatch tree and snapshot: recall, TE, RE, pairs and est.log equal
     the eval path's one-process run.
   * "synthetic eval 3DMatch / KITTI": ``scripts.synthetic_eval.main`` with
     the eval path's snapshots over 2 + 2 rooms, 2 KITTI scenes and one
     room with ``--exact``: the GT cross-check's gates, every pair's
     launches, the record against the per-pair lines; ms/pair.
   * "calibrate": ``scripts.calibrate.main`` over the eval 3DMatch tree
     (host work), its suggestions beside the shipped preset's caps.
   * "last modules" (``last_modules_path``, after the recorded runs): a
     KITTI pair at the dense-LiDAR plan (81920 level-0 points, past the
     banded kernels' 65536-rank reach) eager and through
     ``make_register_fn`` (bit-equal; KITTI's launches less the two
     banded-kNN launches the fallback ``radius_knn_banded`` took; its FPS
     and banded 1-NN calls bit-equal to their plain versions); the
     fallbacks at that shape scored against the exact searches (recall >
     0.97, 1-NN agreement > 0.99; the 1-NN also bit-equal as a graph
     replay), with ms and peak memory; ``describe_cloud`` on the main
     path's pair against ``describe_both`` (1e-5) and its plain-version run
     (2e-5), with and without axes; ``estimate_normals`` and
     ``cal_z_axis`` against float64, ``kabsch`` against ``kabsch_quat``
     (1e-5); the weights through flax msgpack files
     (``save_variables``, ``load_file``, ``load_jax_model``) registering
     the pair bit-equal.
   Prints each phase's wall seconds (``phase_s``), ms/pair and a per-stage
   breakdown (CUDA events) of each preset,
   and ms/step (host clock around a synchronized step) and peak memory
   (``torch.cuda.max_memory_allocated``) of each training stage.
3. Runs the first pair of each preset once more with the plain PyTorch
   versions of the kernels on the card (substituted at the kernels' call
   sites), and the ``fused_desc = False`` pair too: keypoint indices and the
   mutual-match count must be equal, the descriptors within 1e-3 and the
   pose within 1e-4; the eval path's 3DMatch tree once more through the
   entry point with the plain versions, held to the same gates pair by
   pair.  One Desc and one Ref
   training step from the same state and draws, with the kernels and with
   the plain versions, under PyTorch's deterministic algorithms: the loss
   within 1e-5 relative, the updated parameters within 1e-6.
4. Holds each kernel against its plain version at the main path's own
   inputs -- every call of the first pair (exact for the banded kNN, the
   banded 1-NN, 1-NN, both FPS entry points and ball sampling; 2e-5 for the
   SPT front; exact for the training front's ball sampling on every call of
   a Desc step) -- and the banded kernels and the batched FPS on the KITTI
   pair too (both timed there as well, the banded calls kernel only; FPS
   per step of its chain too), the exact 1-NN on the KITTI pair's call and
   on both calls of the ``knn_band = 0`` pair, ball sampling of stacked
   points on the ``fused_desc = False`` pair's call, and the banded 1-NN on
   every call of a training step (the pyramid's and the positive-pair
   sampler's), each of these checked and timed; scores the
   banded search against the exact dense search (recall of the true
   in-radius k-NN, > 0.97, and 1-NN index agreement, > 0.99, gated on
   3DMatch, printed for KITTI); times kernel, plain version, the exact
   search the banded kernels stand in for and, where one PyTorch call
   computes the same function, that call (CUDA events after warm-up), and
   ball sampling and both 1-NN kernels also around their C launch alone
   (without the wrapper's preparation); computes each kernel's bound from
   this run's inputs, and, on a line of derived figures of its own, the
   issue floor of the banded kNN, ball sampling and both 1-NN kernels (this
   run's tests x issue slots a test, counted by hand in the inner loops,
   over every fp32 lane at the card's maximum SM clock).

Any failure exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it holds every kernel's
numbers.  Details go to ``chiprun_out/chip_smoke.json``.  Without a CUDA
device the script exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

PEAK_FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
SMS, LANES = 132, 128        # H100 SXM: SMs, fp32 lanes an SM
# issue slots a test, counted by hand in the kernels' inner loops
# (cuobjdump -sass, sm_90a) and not checked by this script: bknn 3 FADD
# (differences), 3 FMUL + 2 FADD (d2), the penalty FADD, the floor FMNMX, a
# LOP3 (row) and 3 FMNMX (winner, runner-up); ball sampling on a miss 3 FMUL
# + 3 FADD, 2 FSETP, a branch and its BSSY/BSYNC; the banded 1-NN as bknn
# with one FMNMX (the column min) in place of three; the exact 1-NN 3 FADD,
# 3 FMUL + 2 FADD, an FSETP and two selects (FSEL, SEL).  Recount them when
# an inner loop changes.
BKNN_SLOTS = 14
BALL_SLOTS = 11
BNN1_SLOTS = 12
NEAREST_SLOTS = 11
N_PAIRS = 3
N_KITTI_PAIRS = 2
KITTI_SEED = 13
RECALL_KNN = 0.97            # tests/test_geom_pallas.py:143
AGREE_NN1 = 0.99
# launches per pair of each kernel on each path (ops/neighbors.py dispatch):
# 3DMatch bands l0/l1 kNN and both pools (l2 has 3072 points, under the
# band), KITTI also l2 (6144 points under its 64-row window); both take the
# banded 1-NN for l0 -> l1 and the exact one for l1 -> l2
PER_PAIR = {
    "3DMatch": {"bknn": 4, "bnn1": 1, "nearest": 1, "fps": 1,
                "ball_sample": 1, "spt_pooled": 1},
    "KITTI": {"bknn": 5, "bnn1": 1, "nearest": 1, "fps": 1, "ball_sample": 1,
              "spt_pooled": 1},
    "3DMatch knn_band=0": {"nearest": 2, "fps": 1, "ball_sample": 1,
                           "spt_pooled": 1},
    "3DMatch fused_desc=False": {"bknn": 4, "bnn1": 1, "nearest": 1, "fps": 1,
                                 "ball_sample_points": 1},
    "farthest_point_sample": {"fps_single": 1},
}
# the eval path: pairs of each tree, the 3DMatch fragments' x slabs of the
# wavy surface, and the KITTI scans' spacing (pair mining pairs a frame
# with the one before the first frame more than 10 m away)
EVAL_PAIRS = {"3DMatch": 3, "KITTI": 2}
EVAL_SLABS = [(-2.6 + 0.6 * i, -0.6 + 0.6 * i) for i in range(4)]
EVAL_GT_PAIRS = [(0, 1), (0, 2), (1, 3)]
EVAL_SCANS, EVAL_SCAN_GAP = 5, 9.5
# seeded random weights whose keypoint detector passes many points at the
# tiny plan (seeds 2, 4 and 7 leave one keypoint a cloud)
EVAL_SNAPSHOT_SEED = 3
TRAIN_PAIRS = 2
TRAIN_STEPS = 3
STAGES = ("Ref", "Desc", "Keypt", "Inlier")
# launches per training (and eval) step on the 3DMatch preset: the pyramid
# as above plus the banded 1-NN of the positive-pair sampler (30720 target
# points > 2 * 4096), and both clouds' patches in one launch past Ref
TRAIN_STEP = {"Ref": {"bknn": 4, "bnn1": 2, "nearest": 1}}
TRAIN_STEP.update({s: dict(TRAIN_STEP["Ref"], ball_sample_points=1)
                   for s in STAGES[1:]})
# the same on the KITTI preset: its pyramid bands level 2 too
KITTI_TRAIN_STEP = {"Ref": {"bknn": 5, "bnn1": 2, "nearest": 1}}
KITTI_TRAIN_STEP.update({s: dict(KITTI_TRAIN_STEP["Ref"], ball_sample_points=1)
                         for s in STAGES[1:]})
STEP_LAUNCHES = {"3DMatch": TRAIN_STEP, "KITTI": KITTI_TRAIN_STEP}
# the pyramid of device-built levels launches what the host-built one does
PER_PAIR["3DMatch device levels"] = PER_PAIR["3DMatch"]
# the presets through the test entry point, one pair each: ThreeD2ETH and
# KITTI2ThreeD have 3DMatch's static plan, ThreeD2KITTI KITTI's bands
# (its 16384-point level 1 is banded like KITTI's 20480)
PER_PAIR.update({"ThreeD2ETH": PER_PAIR["3DMatch"],
                 "KITTI2ThreeD": PER_PAIR["3DMatch"],
                 "ThreeD2KITTI": PER_PAIR["KITTI"]})
EVAL_PAIRS.update({"ThreeD2ETH": 1, "KITTI2ThreeD": 1, "ThreeD2KITTI": 1})
# train_then_register's held-out pairs on small_cfg (4096/2048/512 points):
# the 4096 band still takes the banded kNN at levels 0-1 and both pools (the
# window covers the support), but the l0 -> l1 1-NN's 2048-point support is
# under twice the band, so both upsamples take the exact 1-NN
PER_PAIR["train_then_register"] = {"bknn": 4, "nearest": 2, "fps": 1,
                                   "ball_sample": 1, "spt_pooled": 1}
# the train entry's trees: 3DMatch fragments (x slabs of one wavy surface
# a scene) paired consecutively in the overlap file; a KITTI sequence a
# split of scans EVAL_SCAN_GAP apart, which pair mining turns into pairs
# (0, 1), (2, 3), ...
TRAIN_TREE_FRAGMENTS = {"train": 4, "val": 2}
TRAIN_TREE_SCANS = {"train": (0, 7), "val": (6, 3)}   # sequence, scans
TRAIN_ENTRY_STEPS = 3
# train_then_register at a reduced count (a plumbing gate): pairs, epochs,
# held-out pairs
TTR_ARGS = ("--train-pairs", "8", "--epochs", "1", "--eval-pairs", "4")
# the data-parallel paths: timed rounds (after warm-up rounds) of the
# pairs/s figure, training steps a stage (the first the program's warm-up
# and capture, each beside the eager DP step from the same state), and the
# launcher's time limit a launch
DP_ITERS, DP_WARMUP = 6, 2
# (name, world, backend, pairs, timed rounds) of "dp register 3DMatch":
# both ranks of world 2 share the card, which NCCL refuses, so gloo;
# NCCL's path at world 1
DP_REGISTER_RUNS = (("world 2 gloo", 2, "gloo", 3, DP_ITERS),
                    ("world 1 gloo", 1, "gloo", 1, DP_ITERS),
                    ("world 1 nccl", 1, "nccl", 3, 0))
DP_TRAIN_STEPS = 3
DP_TIMEOUT = 300.0
# the synthetic evaluation's exact stack: unbanded search (the exact 1-NN
# for both upsamples) and the sampled descriptor front
SYNTH_EXACT_PAIR = {"nearest": 2, "fps": 1, "ball_sample_points": 1}
# the compiled program (make_register_fn): the kernels each launch counter
# stands for, by their __global__ names in csrc/ (a profile of a replay
# must show each as often as its counter rose), the replays timed a
# preset (host clock), and the CUDA runtime calls that are host dispatches
GLOBALS = {"bknn": ("bknn_pack_kernel", "bknn_kernel"),
           "bnn1": ("bnn1_pack_kernel", "bnn1_kernel"),
           "nearest": ("nearest_kernel",), "fps": ("fps_cluster_kernel",),
           "fps_single": ("fps_cluster_kernel",),
           "ball_sample": ("ball_pack_kernel", "ball_kernel"),
           "ball_sample_points": ("ball_pack_kernel", "ball_kernel"),
           "spt_pooled": ("spt_kernel",)}
PROGRAM_TIMED = 6
# the unrolled program (make_unrolled_register_fn): the pairs a call of
# each preset's runs, U = 1 first (the others are read beside it)
UNROLL = {"3DMatch": (1, 2, 3), "KITTI": (1, 2)}
# torch.profiler lost the first kernels of a profiled call now and then,
# after utils.profiling.settle() too (a train-program replay showed 3 of
# the 4 banded-kNN launches its counter saw), and in some processes the
# same first records of every window (hence utils.profiling.open_window's
# spin kernels and profile_call's warm-up call): a profile that shows
# fewer kernels than the counters is taken again, up to this many times
PROFILE_ATTEMPTS = 3
# "last modules": the dense-LiDAR plan, the KITTI preset with 81920
# level-0 points (the loader's cap raised to match), past the banded
# kernels' 65536-rank reach, so the level-0 kNN and pool 0 take the
# fallback radius_knn_banded and the other searches KITTI's kernels; one
# cloud's descriptors (describe_cloud) launch the stacked-point ball
# sampling and the SPT front; the 1-NN fallback's queries are the level-0
# points moved by this much noise (m)
DENSE_POINTS = 81920
PER_PAIR["KITTI dense"] = dict(PER_PAIR["KITTI"],
                               bknn=PER_PAIR["KITTI"]["bknn"] - 2)
DESCRIBE_CLOUD = {"ball_sample_points": 1, "spt_pooled": 1}
NN_JITTER = 0.05
DISPATCH_APIS = (r"(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel|"
                 r"cuLaunchKernelEx|cudaGraphLaunch|cudaMemcpyAsync|"
                 r"cudaMemsetAsync)(_v\d+)?")
# profile_call's two spans
PROFILE_SPANS = ("warm-up call", "profiled call")


def sm_clock_hz() -> float:
    """The card's maximum SM clock as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def issue_floor_ms(tests: float, slots: int, clock_hz: float) -> float:
    """Milliseconds of pure issue: tests x slots over every fp32 lane."""
    return 1e3 * tests * slots / (SMS * LANES * clock_hz)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of flops over the fp32 peak and
    bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_launches(path: str, rose: dict, want: dict = None) -> None:
    """Every kernel of the path ran on this pair (or step) as often as the
    dispatch says, and no other kernel ran."""
    want = PER_PAIR[path] if want is None else want
    if {k: v for k, v in rose.items() if v or k in want} != want:
        raise RuntimeError(f"{path}: launches {rose}, expected {want}")


@contextlib.contextmanager
def capture(mod, name: str, calls: list):
    """Within the block every call of ``mod.name`` is recorded in ``calls``
    as its positional arguments."""
    fn = getattr(mod, name)

    def recorded(*args):
        calls.append(args)
        return fn(*args)

    setattr(mod, name, recorded)
    try:
        yield
    finally:
        setattr(mod, name, fn)


def drive(path: str, model, dev, pairs, draws):
    """register_pair over ``pairs``; every count set to 0 just before and
    read just after.  Returns (launches, ms per pair, results, stage ms)."""
    import torch
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.pipeline import registration
    cuda.reset_launches()
    per_pair, results, stages = [], [], []
    for inputs, dr in zip(pairs, draws):
        before = cuda.launch_counts()
        timer = registration.StageTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = registration.register_pair(model, inputs, dr, device=dev,
                                         timer=timer)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        after = cuda.launch_counts()
        check_launches(path, {k: after[k] - before[k] for k in after})
        per_pair.append(ms)
        results.append(res)
        stages.append(timer.stage_ms())
    return cuda.launch_counts(), per_pair, results, stages


def path_line(path: str, cfg, launches, per_pair, results, stages, prep_s,
              pair0) -> dict:
    """Checks the outputs of a driven path and summarizes it."""
    import torch
    for r in results:
        if not torch.isfinite(r.pose).all():
            raise RuntimeError(f"{path}: non-finite pose")
        if r.pose.shape != (4, 4) or r.kpts.shape != (2, cfg.point.num_keypts, 3):
            raise RuntimeError(f"{path}: unexpected output shapes")
    n_kpts = [[int(v) for v in r.kpt_valid.sum(1)] for r in results]
    if min(min(n) for n in n_kpts) <= 0:
        raise RuntimeError(f"{path}: no eligible keypoints: {n_kpts}")
    warm = per_pair[1:] or per_pair
    steady = stages[1:] or stages
    line = {"path": path, "pairs": len(per_pair), "host_prep_s": prep_s,
            "valid_points": {f: [int(m.sum()) for m in getattr(pair0, f)]
                             for f in ("raw_mask", "sds_mask", "lvl1_mask",
                                       "lvl2_mask")},
            "ms_per_pair": sum(warm) / len(warm), "first_pair_ms": per_pair[0],
            "per_pair_ms": per_pair,
            "stage_ms": {k: sum(s[k] for s in steady) / len(steady)
                         for k in stages[0]},
            "eligible_keypoints": n_kpts,
            "num_mutual": [int(r.num_mutual) for r in results],
            "num_inliers": [int(r.num_inliers) for r in results],
            "launches": launches}
    print(json.dumps(line))
    return line


def plain_path_check(path: str, model, dev, inputs, draws, kernel_run) -> dict:
    """The pair once more through the plain versions: the same keypoints and
    mutual count, descriptors within 1e-3, pose within 1e-4."""
    import torch
    from buffer_tpu_torch.kernels import cuda, sites
    from buffer_tpu_torch.pipeline import registration
    res_k, inter_k = kernel_run
    before = cuda.launch_counts()
    with sites.plain_versions():
        res_p, inter_p = registration.register_pair(
            model, inputs, draws, device=dev, return_intermediates=True)
    if cuda.launch_counts() != before:
        raise RuntimeError(f"{path}: a kernel ran on the plain path")
    if not torch.equal(inter_k["kidx"], inter_p["kidx"]):
        raise RuntimeError(f"{path}: keypoint indices differ between kernels "
                           "and plain")
    pose_err = float((res_k.pose - res_p.pose).abs().max())
    desc_err = max(float((inter_k[n] - inter_p[n]).abs().max())
                   for n in ("s_des", "t_des"))
    if (int(res_k.num_mutual) != int(res_p.num_mutual) or pose_err > 1e-4
            or desc_err > 1e-3):
        raise RuntimeError(f"{path}: kernel and plain paths disagree: mutual "
                           f"{int(res_k.num_mutual)} vs {int(res_p.num_mutual)}, "
                           f"pose {pose_err}, descriptors {desc_err}")
    out = {"path": path, "kidx_equal": True,
           "num_mutual": int(res_k.num_mutual), "desc_max_abs_err": desc_err,
           "pose_max_abs_err": pose_err}
    print(json.dumps({"plain_path_check": out}))
    return out


def recorded_run(model, dev, inputs, draws,
                 names=("banded_knn_cuda", "banded_nn1_cuda", "nearest_cuda")):
    """register_pair of one pair with the arguments of every call of the
    named kernel wrappers (as ``ops.neighbors`` calls them) recorded:
    (result, intermediates, {wrapper: [args]})."""
    from buffer_tpu_torch.ops import neighbors
    from buffer_tpu_torch.pipeline import registration
    calls = {name: [] for name in names}
    with contextlib.ExitStack() as stack:
        for name, store in calls.items():
            stack.enter_context(capture(neighbors, name, store))
        res, inter = registration.register_pair(
            model, inputs, draws, device=dev, return_intermediates=True)
    return res, inter, calls


def knn_recall(got, exact, query_valid, r2_prefix=None) -> float:
    """Mean share of the true in-radius k-NN (the exact search's valid
    slots) present in the banded result, over valid queries that have any.
    ``r2_prefix`` restricts both to d2 <= r2 (the radius-free level-0 list
    is scored on the prefix the conv uses)."""
    import torch
    d, i, v = got
    de, ie, ve = exact
    if r2_prefix is not None:
        v = v & (d <= r2_prefix)
        ve = ve & (de <= r2_prefix)
    i = torch.where(v, i, torch.full_like(i, -1))
    hit = ((ie[..., :, None] == i[..., None, :]).any(-1) & ve).sum(-1)
    n = ve.sum(-1)
    ok = query_valid & (n > 0)
    return float((hit[ok].float() / n[ok].float()).mean())


def banded_entries(calls, cfg, time_plain: bool = True):
    """Checks the banded kernels bit-equal to their plain versions on every
    recorded call, scores them against the exact search and times them
    (the plain versions and the exact search too when ``time_plain``).
    Returns per-kernel sums and per-call rows."""
    import torch
    from buffer_tpu_torch.kernels import knn_cuda
    from buffer_tpu_torch.ops import neighbors
    r0 = cfg.data.voxel_size_0 * cfg.point.conv_radius
    rows, sums = [], {}

    def add(kernel, row):
        rows.append(row)
        s = sums.setdefault(kernel, {"calls": 0, "ms": 0.0, "plain_ms": 0.0,
                                     "exact_ms": 0.0, "launch_ms": 0.0,
                                     "flops": 0.0, "bytes": 0.0, "tests": 0,
                                     "score": []})
        s["calls"] += 1
        for key in ("ms", "plain_ms", "exact_ms", "launch_ms", "flops", "bytes",
                    "tests"):
            s[key] += row.get(key) or 0.0
        s["score"].append(row["score"])

    for q, s, sv, qv, k, radius, wr in calls["banded_knn_cuda"]:
        args = (q, s, sv, qv, k, radius, wr)
        got = knn_cuda.banded_knn_cuda(*args)
        want = knn_cuda.banded_knn_plain(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"bknn: kernel and plain differ at Q={q.shape[1]}"
                               f" S={s.shape[1]} k={k} radius={radius}")
        exact = neighbors.radius_knn(q, s, sv, k, radius if radius else r0)
        score = knn_recall(got, exact, qv, None if radius else r0 * r0)
        B, Q, S = q.shape[0], q.shape[1], s.shape[1]
        _, LW = knn_cuda.window_rows(S, wr)
        row = {"kernel": "bknn", "Q": Q, "S": S, "k": k, "radius": radius,
               "window_rows": LW, "score": score,
               "tests": B * Q * LW * knn_cuda.NSEG,
               "flops": B * Q * LW * knn_cuda.NSEG * 8,
               "bytes": B * (Q * 13 + S * 13 + Q * k * 9),
               "plan": knn_cuda.bknn_plan(B, Q, S, LW)}
        row["ms"] = cuda_ms(lambda: knn_cuda.banded_knn_cuda(*args), 20)
        if time_plain:
            row["plain_ms"] = cuda_ms(lambda: knn_cuda.banded_knn_plain(*args), 2)
            row["exact_ms"] = cuda_ms(
                lambda: neighbors.radius_knn(q, s, sv, k, radius), 3)
        add("bknn", row)

    for q, s, sv, qv in calls["banded_nn1_cuda"]:
        got = knn_cuda.banded_nn1_cuda(q, s, sv, qv)
        want = knn_cuda.banded_nn1_plain(q, s, sv, qv)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError("bnn1: kernel and plain differ")
        _, ie = neighbors.nearest_cuda(q, s, sv)
        score = float((got[1] == ie)[qv].float().mean())
        B, Q, S = q.shape[0], q.shape[1], s.shape[1]
        _, LW = knn_cuda.window_rows(S, knn_cuda.NN1_WIN_ROWS)
        row = {"kernel": "bnn1", "Q": Q, "S": S, "window_rows": LW,
               "score": score, "tests": B * Q * LW * knn_cuda.NSEG,
               "flops": B * Q * LW * knn_cuda.NSEG * 8,
               "bytes": B * (Q * 13 + S * 13 + Q * 8),
               "plan": knn_cuda.bnn1_plan(B, Q, S)}
        row["ms"] = cuda_ms(lambda: knn_cuda.banded_nn1_cuda(q, s, sv, qv), 20)
        row["launch_ms"] = cuda_ms(knn_cuda.bnn1_launcher(
            q, s, sv, qv, [torch.empty_like(x) for x in got]), 20)
        if time_plain:
            row["plain_ms"] = cuda_ms(
                lambda: knn_cuda.banded_nn1_plain(q, s, sv, qv), 2)
            row["exact_ms"] = cuda_ms(lambda: cdist_nn(q, s, sv), 3)
        add("bnn1", row)
    for row in rows:
        print(json.dumps({"banded_call": row}))
    return sums, rows


def topk_library(calls, cfg) -> dict:
    """Stage B's library time (``topk_packed_tpu``, which runs inside the
    bknn launch and has no time of its own there): at the pair's level-0
    banded kNN call (Q = S = points_l0, k = max(normal_knn,
    neighbor_caps[0])), one ``torch.topk(torch.cat([k1, k2], -1), k,
    largest=False)`` over the two candidate fields of stage A
    (``knn_cuda.banded_candidates``), timed by CUDA events after one
    warm-up; its keys must equal the plain stage B's (``topk_keys_plain``)
    in every slot that holds a neighbour (the rest are knock-out values)."""
    import torch
    from buffer_tpu_torch.kernels import knn_cuda
    st = cfg.static
    k = max(st.normal_knn, st.neighbor_caps[0])
    q, s, sv, qv, _, radius, wr = next(
        a for a in calls if a[0].shape[1] == a[1].shape[1] == st.points_l0
        and a[4] == k)
    k1, k2 = knn_cuda.banded_candidates(q, s, sv, qv, radius, wr)
    top = lambda: torch.topk(torch.cat([k1, k2], -1), k, dim=-1,
                             largest=False)
    plain = knn_cuda.topk_keys_plain(torch.cat([k1, k2], -1), k)
    held = knn_cuda.decode(plain, s.shape[1])[2]
    if not torch.equal(top().values[held], plain[held]):
        raise RuntimeError("bknn stage B: torch.topk and topk_keys_plain "
                           "differ")
    return {"ms_topk_library": cuda_ms(top, 20),
            "topk_library_call": [*k1.shape[:2], 2 * k1.shape[2], k]}


def cdist_nn(q, s, valid, chunk=4096):
    """Exact 1-NN by one PyTorch call per query chunk (``torch.cdist`` and
    ``min``): the yardstick of the 1-NN kernel."""
    import torch
    far = torch.where(valid[..., None], s, torch.full_like(s, 1e6))
    return [torch.cdist(q[:, i:i + chunk], far).min(dim=2)
            for i in range(0, q.shape[1], chunk)]


def state_of(model, stage: str) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.startswith(stage + ".")}


def counted(fn, name: str, want: dict):
    """fn() with the launches it makes checked against ``want``; returns
    (result, host ms around the synchronized call, the launches it made)."""
    import torch
    from buffer_tpu_torch.kernels import cuda
    before = cuda.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    after = cuda.launch_counts()
    rose = {k: after[k] - before[k] for k in after}
    check_launches(name, rose, want)
    return out, ms, rose


def train_path(dev, cfg, batches, save_dir: str, gen) -> dict:
    """Stage-sequential training through the ``Trainer`` entry points; every
    count set to 0 just before and read just after.  Returns the summary
    (raises on any failed check)."""
    import torch
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.train import checkpoint
    from buffer_tpu_torch.train.trainer import BEST_METRIC, Trainer
    from buffer_tpu_torch.utils.logging import MetricLogger

    model = BufferModel(cfg, seed=0).to(dev)
    logger = MetricLogger(os.path.join(save_dir, "metrics.jsonl"), echo=False)
    stages = []
    cuda.reset_launches()
    for stage in STAGES:
        trainer = Trainer(cfg, model, stage, save_dir, logger=logger, device=dev)
        lr = trainer.set_epoch_lr(0)
        before = {s: state_of(model, s) for s in STAGES}
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        for i in range(TRAIN_STEPS):
            draws = make_train_draws(cfg, gen, dev)
            (loss, stats), t, step_launches = counted(
                lambda: trainer.step(batches[i % len(batches)], draws),
                f"train {stage}", TRAIN_STEP[stage])
            if not all(bool(torch.isfinite(v)) for v in stats.values()):
                raise RuntimeError(f"train {stage}: non-finite stats {stats}")
            if float(stats["grad_finite"]) != 1.0:
                raise RuntimeError(f"train {stage}: a step was skipped")
            ms.append(t)
            losses.append(float(loss))
        res, eval_ms, _ = counted(lambda: trainer.evaluate(batches[:1], gen),
                                  f"eval {stage}", TRAIN_STEP[stage])
        if not all(math.isfinite(v) for v in res.values()):
            raise RuntimeError(f"eval {stage}: non-finite stats {res}")
        trainer.end_epoch(0, res)
        peak = torch.cuda.max_memory_allocated()
        after = {s: state_of(model, s) for s in STAGES}
        moved = [k for k, v in after[stage].items() if "running" not in k
                 and "num_batches" not in k and not torch.equal(v, before[stage][k])]
        if not moved:
            raise RuntimeError(f"train {stage}: no parameter moved")
        for s in STAGES:
            if s != stage and any(not torch.equal(v, before[s][k])
                                  for k, v in after[s].items()):
                raise RuntimeError(f"train {stage}: frozen stage {s} changed")
        sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        for name in ("best", 0):
            got = checkpoint.load(trainer.checkpoint_path(name))
            if set(got) != set(sd) or any(not torch.equal(got[k], sd[k])
                                          for k in sd):
                raise RuntimeError(f"train {stage}: checkpoint {name} does "
                                   "not reload equal")
        warm = ms[1:]
        line = {"path": "3DMatch train", "stage": stage, "lr": lr,
                "steps": TRAIN_STEPS, "first_step_ms": ms[0],
                "ms_per_step": sum(warm) / len(warm), "step_ms": ms,
                "eval_ms": eval_ms, "peak_mem_bytes": peak, "losses": losses,
                "eval": res, "metric": BEST_METRIC[stage],
                "params_moved": len(moved),
                "launches_last_step": {k: v for k, v in step_launches.items()
                                       if v}}
        print(json.dumps(line))
        stages.append(line)
    return {"model": model, "stages": stages, "launches": cuda.launch_counts()}


def plain_train_check(stage, model, cfg, batch, draws, dev, save_dir,
                      path: str = "3DMatch train") -> dict:
    """One training step of ``stage`` from the same state and draws with the
    kernels and with the plain versions, under PyTorch's deterministic
    algorithms: loss within 1e-5 relative, updated parameters within 1e-6."""
    import copy
    import torch
    from buffer_tpu_torch.kernels import cuda, sites
    from buffer_tpu_torch.train.trainer import Trainer
    from buffer_tpu_torch.utils.logging import MetricLogger
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for plain in (False, True):
            m = copy.deepcopy(model)
            tr = Trainer(cfg, m, stage, save_dir, device=dev,
                         logger=MetricLogger(None, echo=False))
            before = cuda.launch_counts()
            with sites.plain_versions() if plain else contextlib.nullcontext():
                loss, _ = tr.step(batch, draws)
            if plain and cuda.launch_counts() != before:
                raise RuntimeError(f"train {stage}: a kernel ran on the plain path")
            runs.append((float(loss), state_of(m, stage)))
    finally:
        torch.use_deterministic_algorithms(False)
    (lk, pk), (lp, pp) = runs
    loss_rel = abs(lk - lp) / max(abs(lp), 1e-30)
    param_err = max(float((pk[k].float() - pp[k].float()).abs().max())
                    for k in pk if pk[k].is_floating_point())
    out = {"path": path, "stage": stage, "loss_kernels": lk,
           "loss_plain": lp, "loss_rel_err": loss_rel,
           "param_max_abs_err": param_err}
    print(json.dumps({"plain_train_check": out}))
    if loss_rel > 1e-5 or param_err > 1e-6:
        raise RuntimeError(f"{path} {stage}: kernel and plain steps disagree: "
                           f"{out}")
    return out


def tensors_equal(a, b) -> bool:
    """Bit for bit, NaN equal to NaN."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        nan = torch.isnan(a)
        return (torch.equal(nan, torch.isnan(b))
                and torch.equal(torch.where(nan, 0, a), torch.where(nan, 0, b)))
    return torch.equal(a, b)


def step_state(model, optimizer) -> dict:
    """The model's state dict and Adam's state, as copies."""
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for i, g in enumerate(optimizer.param_groups):
        for j, p in enumerate(g["params"]):
            sd.update({f"adam.{i}.{j}.{k}": v.clone()
                       for k, v in optimizer.state[p].items()})
    return sd


def states_equal(a: dict, b: dict) -> list:
    """The keys where two ``step_state``s differ."""
    return [k for k in a if not tensors_equal(a[k], b[k])]


def load_step_state(model, optimizer, sd: dict) -> None:
    """A ``step_state`` back into the model and Adam, in place."""
    import torch
    model.load_state_dict({k: v for k, v in sd.items()
                           if not k.startswith("adam.")})
    with torch.no_grad():
        for i, g in enumerate(optimizer.param_groups):
            for j, p in enumerate(g["params"]):
                for k, v in optimizer.state[p].items():
                    v.copy_(sd[f"adam.{i}.{j}.{k}"])


def step_errors(a: dict, b: dict, stage: str):
    """(max abs difference, elements differing) over ``stage``'s
    parameters of two ``step_state``s."""
    keys = [k for k in a if k.startswith(stage + ".") and "running" not in k
            and "num_batches" not in k]
    return (max(float((a[k] - b[k]).abs().max()) for k in keys),
            sum(int((a[k] != b[k]).sum()) for k in keys))


def adam_check(dev, cfg, model) -> dict:
    """``make_optimizer``'s capturable Adam (tensor learning rate on the
    card) against the float-rate Adam on the same gradients, three steps of
    the Inlier stage at the epoch-3 rate: every parameter within 1e-3 lr,
    the allowance ``tests/test_torch_train.py`` holds the port's Adam to
    against optax."""
    import copy
    import torch
    from buffer_tpu_torch.train import trainer as tr
    stage = "Inlier"
    a, b = copy.deepcopy(model), copy.deepcopy(model)
    opt_a, lr_for_epoch = tr.make_optimizer(cfg, a, stage)
    lr = lr_for_epoch(3)
    tr.set_lr(opt_a, lr)
    opt_b = torch.optim.Adam(getattr(b, stage).parameters(), lr=lr,
                             weight_decay=cfg.optim.weight_decay)
    gen = torch.Generator(device=dev).manual_seed(21)
    pa, pb = list(getattr(a, stage).parameters()), list(getattr(b, stage).parameters())
    for _ in range(3):
        for x, y in zip(pa, pb):
            g = torch.randn(x.shape, generator=gen, device=dev)
            g = torch.where(torch.rand(x.shape, generator=gen, device=dev) < 0.1,
                            torch.zeros_like(g), g)
            x.grad, y.grad = g.clone(), g.clone()
        opt_a.step()
        opt_b.step()
    err = max(float((x - y).abs().max()) for x, y in zip(pa, pb))
    out = {"path": "adam capturable vs float lr", "stage": stage, "lr": lr,
           "steps": 3, "param_max_abs_err": err, "err_over_lr": err / lr}
    print(json.dumps(out))
    if err > 1e-3 * lr:
        raise RuntimeError(f"capturable Adam differs from the float-rate Adam: {out}")
    return out


def train_program_path(path: str, dev, cfg, batches, gen, save_dir: str) -> dict:
    """The compiled training steps (``Trainer.step`` and ``Trainer.evaluate``
    through ``make_train_step`` / ``make_eval_step``) at a preset's full
    static plan on ``batches``, stage after stage from a seeded model, with
    a twin model stepped eagerly (``train_step``) on the same batches and
    draws; every count set to 0 just before each step and read just after.

    Under deterministic algorithms a stage takes 4 steps: the first call
    (eager warm-up, capture), a replay, a replay after ``set_epoch_lr``
    moved the rate, and a replay with a NaN ground-truth pose (data-borne:
    Ref's gradient is not finite and the step is skipped -- nothing moves
    but the running statistics, ``grad_finite`` 0); each step bit-equal to
    the twin's eager step (loss, stats, parameters, buffers, Adam's state),
    each launching the ``STEP_LAUNCHES`` table; two eval calls bit-equal to
    ``eval_step``; only the active stage moves.  Then in default mode a new
    ``Trainer`` (new programs): from the state after the first call, a
    replay and two eager steps of the twin: the replay's loss within 1e-5
    (relative) of the eager one's and its parameters within 2 lr (the
    backward's atomic sums may reorder between any two runs, and Adam moves
    an element whose gradient lies at rounding of zero by up to ~lr either
    way; the two eager steps' spread is printed beside); ms/step of program replays
    and eager steps (host clock around a synchronized call,
    ``PROGRAM_TIMED`` each on the same batches and draws), first-call ms,
    capture s, device ms of a replay (CUDA events) and of its kernels, host
    dispatches of one profiled step each, the profiled replay showing each
    kernel's ``__global__`` names as its counters rose, peak memory of the
    program's capture and of eager steps, and reserved memory once the
    stage's programs are dropped.  At the end a replaced parameter makes
    the next call raise."""
    import copy
    import torch
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.train import trainer as tr
    from buffer_tpu_torch.utils.logging import MetricLogger
    preset = path.split()[0]
    table = STEP_LAUNCHES[preset]
    margin = 1.0 if preset == "KITTI" else 1.05
    model = BufferModel(cfg, seed=0).to(dev)
    twin = copy.deepcopy(model)
    logger = MetricLogger(None, echo=False)
    bad = type(batches[0])(batches[0].inputs,
                           torch.full_like(batches[0].relt_pose, float("nan")))
    lines = []

    def check(what, got, want, st_got, st_want):
        (loss, stats), (loss_e, stats_e) = got, want
        diff = states_equal(st_got, st_want)
        if (not tensors_equal(loss, loss_e) or stats.keys() != stats_e.keys()
                or any(not tensors_equal(stats[k], stats_e[k]) for k in stats)
                or diff):
            raise RuntimeError(f"{path} {stage} {what}: program and eager "
                               f"differ ({float(loss)} / {float(loss_e)}, "
                               f"state {diff[:4]})")

    for stage in STAGES:
        twin.load_state_dict(model.state_dict())
        interval = cfg.optim.scheduler_interval[stage]
        start = {s: state_of(model, s) for s in STAGES}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            trainer = tr.Trainer(cfg, model, stage, save_dir, logger=logger,
                                 device=dev)
            opt, lr_for_epoch = tr.make_optimizer(cfg, twin, stage)
            twin.zero_grad(set_to_none=True)
            plan = [(batches[0], 0), (batches[1 % len(batches)], 0),
                    (batches[0], interval), (bad, interval)]
            det_launches = []
            for i, (batch, epoch) in enumerate(plan):
                lr = trainer.set_epoch_lr(epoch)
                tr.set_lr(opt, lr_for_epoch(epoch))
                draws = make_train_draws(cfg, gen, dev)
                held = step_state(model, trainer.optimizer)
                got, _, rose = counted(lambda: trainer.step(batch, draws),
                                       f"{path} {stage}", table[stage])
                want, _, _ = counted(lambda: tr.train_step(
                    twin, opt, stage, batch, draws, margin, dev),
                    f"{path} {stage} eager", table[stage])
                after = step_state(model, trainer.optimizer)
                check(f"step {i}", got, want, after, step_state(twin, opt))
                det_launches.append({k: v for k, v in rose.items() if v})
                finite = float(got[1]["grad_finite"])
                if i == 3 and stage == "Ref":
                    moved = [k for k in states_equal(after, held)
                             if "running" not in k and "num_batches" not in k]
                    if finite != 0.0 or moved:
                        raise RuntimeError(f"{path} Ref: the NaN-pose replay was "
                                           f"not skipped ({finite}, {moved[:4]})")
                elif i < 3 and finite != 1.0:
                    raise RuntimeError(f"{path} {stage}: step {i} was skipped")
            ev = make_train_draws(cfg, gen, dev)
            for k in range(2):
                got, _, _ = counted(lambda: trainer.eval_fn(batches[0], ev),
                                    f"{path} {stage} eval", table[stage])
                want = tr.eval_step(model, stage, batches[0], ev, margin, dev)
                if not all(tensors_equal(a, b) for a, b in
                           zip((got[0], *got[1].values()),
                               (want[0], *want[1].values()))):
                    raise RuntimeError(f"{path} {stage}: eval call {k} differs "
                                       "from eval_step")
        finally:
            torch.use_deterministic_algorithms(False)
        for s in STAGES:
            now = state_of(model, s)
            changed = [k for k, v in now.items() if not torch.equal(v, start[s][k])]
            if s != stage and changed:
                raise RuntimeError(f"{path} {stage}: frozen stage {s} changed")
            if s == stage and not [k for k in changed if "running" not in k
                                   and "num_batches" not in k]:
                raise RuntimeError(f"{path} {stage}: no parameter moved")

        # default algorithms: new programs, timing, dispatches, memory
        twin.load_state_dict(model.state_dict())
        trainer = tr.Trainer(cfg, model, stage, save_dir, logger=logger,
                             device=dev)
        opt, _ = tr.make_optimizer(cfg, twin, stage)
        twin.zero_grad(set_to_none=True)
        draws = [make_train_draws(cfg, gen, dev) for _ in range(2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, first_ms, _ = counted(lambda: trainer.step(batches[0], draws[0]),
                                 f"{path} {stage}", table[stage])
        program_peak = torch.cuda.max_memory_allocated()
        # a replay and two eager steps from one state: the backward's
        # atomic sums may reorder between any two runs in default mode
        start_sd = step_state(model, trainer.optimizer)
        b1 = batches[1 % len(batches)]
        got, _, _ = counted(lambda: trainer.step(b1, draws[1]),
                            f"{path} {stage}", table[stage])
        runs = []
        for _ in range(2):
            load_step_state(twin, opt, start_sd)
            runs.append((tr.train_step(twin, opt, stage, b1, draws[1], margin,
                                       dev)[0], step_state(twin, opt)))
        rel = lambda a, b: abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
        loss_rel, eager_loss_rel = rel(got[0], runs[0][0]), rel(runs[1][0], runs[0][0])
        param_err, param_diffs = step_errors(step_state(model, trainer.optimizer),
                                             runs[0][1], stage)
        eager_err, eager_diffs = step_errors(runs[1][1], runs[0][1], stage)
        lr = lr_for_epoch(0)
        if loss_rel > 1e-5 or param_err > 2 * lr:
            raise RuntimeError(f"{path} {stage}: default-mode replay {loss_rel} "
                               f"/ {param_err} from the eager step")
        (program,) = trainer.train_fn.programs.values()

        def timed(call):
            ms = []
            for k in range(PROGRAM_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call(batches[k % len(batches)], draws[k % 2])
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            return ms

        prog_ms = timed(trainer.step)
        torch.cuda.reset_peak_memory_stats()
        eager_ms = timed(lambda b, d: tr.train_step(twin, opt, stage, b, d,
                                                    margin, dev))
        eager_peak = torch.cuda.max_memory_allocated()
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start_ev.record()
        trainer.step(batches[0], draws[0])
        end_ev.record()
        end_ev.synchronize()
        replay_ms = start_ev.elapsed_time(end_ev)
        (_, seen, n_kernels, dispatches, kernel_ms), _, attempts = \
            profiled_launches(f"{path} {stage}",
                              lambda: trainer.step(batches[0], draws[0]))
        _, _, eager_kernels, eager_dispatches, eager_kernel_ms, _ = profile_call(
            lambda: tr.train_step(twin, opt, stage, batches[0], draws[0],
                                  margin, dev))
        capture_s = program.capture_s
        del program, trainer
        torch.cuda.synchronize()
        line = {"path": path, "stage": stage,
                "bit_equal_steps_deterministic": len(plan),
                "eval_calls_bit_equal": 2,
                "launches_per_step": det_launches[-1],
                "first_call_ms": first_ms, "capture_s": capture_s,
                "ms_per_step": sum(prog_ms) / len(prog_ms), "step_ms": prog_ms,
                "eager_ms_per_step": sum(eager_ms) / len(eager_ms),
                "eager_step_ms": eager_ms,
                "dispatches_per_step": dispatches,
                "eager_dispatches_per_step": eager_dispatches,
                "replay_device_ms": replay_ms, "replay_kernel_ms": kernel_ms,
                "eager_kernel_ms": eager_kernel_ms,
                "kernels_per_replay": n_kernels, "eager_kernels": eager_kernels,
                "profiled_kernels": {n: c for n, c in seen.items() if c},
                "profiles_taken": attempts,
                "default_mode": {"loss_rel_err": loss_rel,
                                 "param_max_abs_err": param_err,
                                 "params_differing": param_diffs,
                                 "eager_vs_eager_loss_rel_err": eager_loss_rel,
                                 "eager_vs_eager_param_max_abs_err": eager_err,
                                 "eager_vs_eager_params_differing": eager_diffs,
                                 "lr": lr},
                "program_peak_mem_bytes": program_peak,
                "eager_peak_mem_bytes": eager_peak,
                "reserved_after_bytes": torch.cuda.memory_reserved()}
        print(json.dumps(line))
        lines.append(line)

    # a replaced parameter makes the next call raise
    trainer = tr.Trainer(cfg, model, "Inlier", save_dir, logger=logger,
                         device=dev)
    trainer.step(batches[0], make_train_draws(cfg, gen, dev))
    p = next(iter(model.Inlier.parameters()))
    owner, name = next((m, n) for m in model.Inlier.modules()
                       for n, q in m.named_parameters(recurse=False) if q is p)
    setattr(owner, name, torch.nn.Parameter(p.detach().clone()))
    try:
        trainer.step(batches[0], make_train_draws(cfg, gen, dev))
    except RuntimeError as e:
        if "captured" not in str(e):
            raise
    else:
        raise RuntimeError(f"{path}: a replaced parameter did not raise")
    return {"stages": lines}


def write_redwood(path: str, pairs, mats, n_frag: int) -> None:
    """A Redwood ``.log`` (4x4) or ``.info`` (6x6) file: 'i j n' then the
    matrix's rows, tab-separated."""
    with open(path, "w") as f:
        for (i, j), m in zip(pairs, mats):
            f.write(f"{i}\t{j}\t{n_frag}\n")
            for row in m:
                f.write("\t".join(repr(float(v)) for v in row) + "\n")


def write_threedmatch_tree(root: str, seed: int) -> str:
    """A 3DMatch test tree: one scene of 4 fragments (x slabs of bench.py's
    wavy surface, 600000 points over 5.2 m x 5.2 m, each fragment in a
    local frame of its own), ``gt.log`` with the inverse of each gt pair's
    source-to-target pose and ``gt.info`` of 100 I.  Returns the scene."""
    import numpy as np
    rs = np.random.RandomState(seed)
    scene = "synthetic-wavy-scene"
    fdir = os.path.join(root, "test", "3DMatch", "fragments", scene)
    gdir = os.path.join(root, "test", "3DMatch", "gt_result", scene)
    poses = write_fragments(fdir, rs, len(EVAL_SLABS), "cloud_bin")
    os.makedirs(gdir)
    write_gt(gdir, EVAL_GT_PAIRS, poses, len(EVAL_SLABS))
    return scene


def write_fragments(fdir: str, rs, n: int, stem: str, scale: float = 1.0):
    """Fragments ``<stem>_<i>.ply`` of one world of bench.py's wavy surface
    (600000 points over 5.2 m x 5.2 m, all times ``scale``): the first
    ``n`` x slabs of ``EVAL_SLABS``, each in a local frame of its own.
    Returns the local-to-world poses."""
    import numpy as np
    from buffer_tpu_torch.data.ply import write_ply_points
    from buffer_tpu_torch.data.synthetic import _shoemake_rotation, wavy_surface
    world = wavy_surface(rs, 600000, 2.6) * np.float32(scale)
    os.makedirs(fdir)
    poses = []
    for i, (lo, hi) in enumerate(EVAL_SLABS[:n]):
        pose = np.eye(4)
        pose[:3, :3] = _shoemake_rotation(rs)
        pose[:3, 3] = rs.uniform(-1.0, 1.0, 3) * scale
        frag = world[(world[:, 0] >= lo * scale) & (world[:, 0] <= hi * scale)]
        write_ply_points(os.path.join(fdir, f"{stem}_{i}.ply"),
                         (frag - pose[:3, 3]) @ pose[:3, :3])
        poses.append(pose)
    return poses


def write_gt(gdir: str, pairs, poses, n_frag: int) -> None:
    """``gt.log`` with the inverse of each pair's source-to-target pose and
    ``gt.info`` of 100 I."""
    import numpy as np
    write_redwood(os.path.join(gdir, "gt.log"), pairs,
                  [np.linalg.inv(np.linalg.inv(poses[j]) @ poses[i])
                   for i, j in pairs], n_frag)
    write_redwood(os.path.join(gdir, "gt.info"), pairs,
                  [100.0 * np.eye(6)] * len(pairs), n_frag)


def write_threedmatch_train_tree(root: str, seed: int) -> None:
    """A 3DMatch training tree: a train scene of TRAIN_TREE_FRAGMENTS
    ["train"] fragments and a val scene of ["val"], each fragment with its
    ``.pose.npy``, the consecutive pairs in ``3DMatch_train_overlap.pkl``
    and the scenes in ``{train,val}_3dmatch.txt``."""
    import pickle
    import numpy as np
    rs = np.random.RandomState(seed)
    overlap = {}
    for split, n in TRAIN_TREE_FRAGMENTS.items():
        scene = f"synthetic-wavy-{split}"
        sdir = os.path.join(root, "train", scene)
        for i, pose in enumerate(write_fragments(sdir, rs, n, "cloud_bin")):
            np.save(os.path.join(sdir, f"cloud_bin_{i}.pose.npy"), pose)
        overlap.update({f"{scene}/cloud_bin_{i}@{scene}/cloud_bin_{i + 1}": 0.7
                        for i in range(n - 1)})
        with open(os.path.join(root, "train", f"{split}_3dmatch.txt"), "w") as f:
            f.write(scene + "\n")
    with open(os.path.join(root, "train", "3DMatch_train_overlap.pkl"), "wb") as f:
        pickle.dump(overlap, f)


def write_kitti_train_tree(root: str, seed: int) -> None:
    """A KITTI training tree: one sequence a split (TRAIN_TREE_SCANS) of
    ``lidar_scene`` scans EVAL_SCAN_GAP apart, named in
    ``{train,val}_kitti.txt``."""
    for k, (split, (seq, scans)) in enumerate(TRAIN_TREE_SCANS.items()):
        write_kitti_tree(root, seed + k, seq, scans)
        with open(os.path.join(root, f"{split}_kitti.txt"), "w") as f:
            f.write(f"{seq}\n")


def write_eth_tree(root: str, seed: int) -> None:
    """An ETH tree: ``gazebo_summer`` with two fragments of the wavy
    surface at ThreeD2ETH's scale (5: 26 m x 26 m) and their pair in
    ``gt.log``; the other three scenes with an empty ``gt.log``."""
    import numpy as np
    from buffer_tpu_torch.data.eth import ETH_SCENES
    rs = np.random.RandomState(seed)
    for k, scene in enumerate(ETH_SCENES):
        sdir = os.path.join(root, scene)
        if k:
            os.makedirs(sdir)
            open(os.path.join(sdir, "gt.log"), "w").close()
            continue
        poses = write_fragments(sdir, rs, 2, "Hokuyo", scale=5.0)
        write_gt(sdir, [(0, 1)], poses, 2)


def write_kitti_tree(root: str, seed: int, seq: int = 8,
                     scans: int = EVAL_SCANS) -> None:
    """A KITTI odometry sequence ``seq``: ``scans`` velodyne scans (float32
    x, y, z, reflectance) of one ``lidar_scene`` from sensor origins
    ``EVAL_SCAN_GAP`` m apart along the road, at ``lidar_pair``'s density,
    and the camera poses in ``poses/<seq>.txt``."""
    import numpy as np
    from buffer_tpu_torch.data.kitti import velo2cam
    from buffer_tpu_torch.data.synthetic import _lidar_view, lidar_scene
    rs = np.random.RandomState(seed)
    scene = lidar_scene(rs)
    vdir = os.path.join(root, "dataset", "sequences", f"{seq:02d}", "velodyne")
    os.makedirs(vdir)
    os.makedirs(os.path.join(root, "dataset", "poses"), exist_ok=True)
    Vc = velo2cam().T                  # velodyne -> camera
    rows = []
    for t in range(scans):
        d = np.array([EVAL_SCAN_GAP * t, 0.0, 0.0])
        # the velodyne frames differ by the translation d, so the camera
        # pose is Vc T(d) Vc^-1, a translation by Vc's rotation of d
        P = np.eye(4)
        P[:3, 3] = Vc[:3, :3] @ d
        rows.append(" ".join(repr(float(v)) for v in P[:3].reshape(-1)))
        scan = _lidar_view(rs, np.array([0.0, 0.0, 1.73]) + d, scene)
        np.concatenate([scan, np.zeros((len(scan), 1), np.float32)], 1
                       ).astype(np.float32).tofile(
            os.path.join(vdir, f"{t:06d}.bin"))
    with open(os.path.join(root, "dataset", "poses", f"{seq:02d}.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


@contextlib.contextmanager
def recorded_programs(mod, calls: list):
    """Within the block every registration program that
    ``mod.make_register_fn`` or ``mod.make_unrolled_register_fn`` makes
    records each pair of its calls in ``calls``: the model, inputs, draws,
    the ``RegistrationResult``, the milliseconds (host clock up to a
    synchronize), the launches it made, and the group (``U``, ``slot``).
    An unrolled call is recorded a pair a slot, with the call's ms and
    launches over U (a group launches U times one pair's table: a rise
    that U does not divide raises); a padded slot (the slot before's very
    inputs, as ``run_eval`` pads) is left out."""
    import torch
    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.pipeline.registration import RegistrationResult

    def timed(fn, dev, args):
        before = cuda.launch_counts()
        t0 = time.perf_counter()
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        after = cuda.launch_counts()
        res = out if isinstance(out, RegistrationResult) else out[0]
        return out, res, ms, {k: after[k] - before[k] for k in after}

    make = mod.make_register_fn
    make_unrolled = getattr(mod, "make_unrolled_register_fn", None)

    def recording(model, device=None, **kw):
        fn = make(model, device=device, **kw)
        dev = resolve_device(device)

        def recorded(inputs, draws):
            out, res, ms, rose = timed(fn, dev, (inputs, draws))
            calls.append({"model": model, "inputs": inputs, "draws": draws,
                          "result": res, "ms": ms, "launches": rose,
                          "U": 1, "slot": 0})
            return out

        return recorded

    def recording_unrolled(model, unroll, device=None, **kw):
        fn = make_unrolled(model, unroll, device=device, **kw)
        dev = resolve_device(device)

        def recorded(inputs_list, draws_list):
            out, res, ms, rose = timed(fn, dev, (inputs_list, draws_list))
            if any(v % unroll for v in rose.values()):
                raise RuntimeError(f"an unrolled call of {unroll} pairs "
                                   f"launched {rose}")
            for u, (inputs, draws) in enumerate(zip(inputs_list, draws_list)):
                if u and inputs is inputs_list[u - 1]:
                    continue
                calls.append({"model": model, "inputs": inputs,
                              "draws": draws, "result": RegistrationResult(
                                  *(t[u] for t in res)),
                              "ms": ms / unroll,
                              "launches": {k: v // unroll
                                           for k, v in rose.items()},
                              "U": unroll, "slot": u})
            return out

        return recorded

    mod.make_register_fn = recording
    if make_unrolled is not None:
        mod.make_unrolled_register_fn = recording_unrolled
    try:
        yield
    finally:
        mod.make_register_fn = make
        if make_unrolled is not None:
            mod.make_unrolled_register_fn = make_unrolled


def run_entry(argv, plain: bool = False):
    """``scripts.test.main(argv)`` with every call of the harness's
    registration program recorded, the counts set to 0 just before; with
    ``plain`` the kernels' plain versions at their call sites (captured
    into the program).  Returns (summary, records, counts, wall seconds)."""
    from buffer_tpu_torch.eval import harness
    from buffer_tpu_torch.kernels import cuda, sites
    from buffer_tpu_torch.scripts import test as entry
    calls = []
    cuda.reset_launches()
    t0 = time.perf_counter()
    with recorded_programs(harness, calls), (
            sites.plain_versions() if plain else contextlib.nullcontext()):
        out = entry.main(argv)
    return out, calls, cuda.launch_counts(), time.perf_counter() - t0


def eval_run(dev, preset: str, root: str, flag: str, weights: str, log_dir: str,
             gts: list, want_state: dict, extra=(), path: str = "eval") -> tuple:
    """One run of the test entry point over a written tree (``extra``:
    further arguments), with its gates; returns (printed line, records)."""
    import numpy as np
    import torch
    from buffer_tpu_torch.config import make_cfg
    from buffer_tpu_torch.eval import harness, metrics
    from buffer_tpu_torch.pipeline import registration
    name = f"{path} {preset} {flag}"
    dataset = make_cfg(preset).data.dataset
    out, calls, counts, wall = run_entry(
        ["--config", preset, "--data-root", root, flag, weights,
         "--log-dir", log_dir, "--device", str(dev), *extra])
    n = EVAL_PAIRS[preset]
    if out["pairs"] != n or len(calls) != n:
        raise RuntimeError(f"{name}: {out['pairs']} pairs, {len(calls)} "
                           f"registrations, expected {n}")
    for c in calls:
        check_launches(preset, c["launches"])
    # run_eval groups the pairs by the preset's pair_unroll (one pair: 1)
    U = make_cfg(preset).static.pair_unroll if n > 1 else 1
    if [c["U"] for c in calls] != [U] * n:
        raise RuntimeError(f"{name}: groups {[c['U'] for c in calls]}, "
                           f"expected {U} a pair")
    state = calls[0]["model"].state_dict()
    for k, v in want_state.items():
        if not k.endswith("num_batches_tracked") or flag == "--weights":
            if not torch.equal(state[k].cpu(), v):
                raise RuntimeError(f"{name}: loaded {k} differs from the file")
    first = calls[0]
    # the first pair is the program's warm-up, the others its replays
    for j, c in enumerate(calls):
        again = registration.register_pair(c["model"], c["inputs"],
                                           c["draws"], device=dev)
        if not results_equal(again, c["result"]):
            raise RuntimeError(f"{name}: run_eval's result of pair {j} is not "
                               "register_pair's on the same inputs and draws")
    poses = [c["result"].pose.cpu().numpy().astype(np.float64) for c in calls]
    scene = sorted(os.listdir(log_dir))
    if len(scene) != 1:
        raise RuntimeError(f"{name}: est.log scenes {scene}")
    _, traj = metrics.read_trajectory(os.path.join(log_dir, scene[0], "est.log"))
    inv = np.stack([np.linalg.inv(p) for p in poses])
    if traj.shape != inv.shape or not np.allclose(traj, inv, rtol=1e-6,
                                                  atol=1e-6):
        raise RuntimeError(f"{name}: est.log is not the inverse poses")
    rte_th, rre_th = harness.THRESHOLDS[dataset]
    states = []
    for p, gt in zip(poses, gts):
        rte, rre = metrics.rte_rre(p, np.asarray(gt, np.float64))
        states.append([float(rte < rte_th and rre < rre_th), rte, rre])
    want = metrics.dgr_recall(np.array(states))
    for k, v in want.items():
        if not (v == out[k] or (math.isnan(v) and math.isnan(out[k]))):
            raise RuntimeError(f"{name}: {k} {out[k]}, per-pair records {v}")
    rr = out.get("registration_recall")
    if (dataset in ("3DMatch", "3DLoMatch")) != (rr is not None) or (
            rr is not None and not 0.0 <= rr <= 1.0):
        raise RuntimeError(f"{name}: registration recall {rr}")
    if not all(bool(torch.isfinite(c["result"].pose).all()) for c in calls):
        raise RuntimeError(f"{name}: non-finite pose")
    n_kpts = [[int(v) for v in c["result"].kpt_valid.sum(1)] for c in calls]
    if min(min(k) for k in n_kpts) <= 0:
        raise RuntimeError(f"{name}: no eligible keypoints: {n_kpts}")
    line = {"path": path, "preset": preset, "weights": flag, "pairs": n,
            "model_ms_per_pair": 1e3 * out["model_time"],
            "data_ms_per_pair": 1e3 * out["data_time"], "wall_s": wall,
            "recall": out["recall"], "TE": out["TE"], "RE": out["RE"],
            "registration_recall": rr,
            "launches_per_pair": {k: v for k, v in calls[0]["launches"].items()
                                  if v},
            "register_ms": [c["ms"] for c in calls],
            "pair_unroll": [c["U"] for c in calls],
            "eligible_keypoints": n_kpts,
            "launches": counts, "rte_rre": [s[1:] for s in states],
            "num_mutual": [int(c["result"].num_mutual) for c in calls],
            "valid_points": {f: [int(m.sum()) for m in getattr(
                first["inputs"], f)] for f in ("raw_mask", "sds_mask")}}
    print(json.dumps(line))
    return line, calls


def eval_path(dev, cfg, kcfg, train_dir: str) -> dict:
    """The evaluation path through the test entry point over trees written
    into ``build/eval_smoke/`` (afresh: KITTI's ICP cache lives there), then
    the 3DMatch tree once more with the plain versions."""
    import torch
    from buffer_tpu_torch.data.kitti import KITTIDataset
    from buffer_tpu_torch.data.threedmatch import ThreeDMatchDataset
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.train.checkpoint import merge_stage_checkpoints
    base = str(cuda.BUILD_DIR / "eval_smoke")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.time()
    roots = {"3DMatch": os.path.join(base, "ThreeDMatch"),
             "KITTI": os.path.join(base, "KITTI")}
    write_threedmatch_tree(roots["3DMatch"], 21)
    write_kitti_tree(roots["KITTI"], 22)
    snapshots = {}
    for preset, c in (("3DMatch", cfg), ("KITTI", kcfg)):
        sd = BufferModel(c, seed=EVAL_SNAPSHOT_SEED).state_dict()
        d = os.path.join(base, f"snapshot_{preset}")
        for stage in STAGES:
            os.makedirs(os.path.join(d, stage))
            torch.save(sd, os.path.join(d, stage, "best.pth"))
        snapshots[preset] = (d, sd)
    gts = {"3DMatch": [], "KITTI": []}
    for preset, ds in (("3DMatch", ThreeDMatchDataset), ("KITTI", KITTIDataset)):
        c = (cfg if preset == "3DMatch" else kcfg)
        d = ds("test", c.replace(data=dataclasses.replace(
            c.data, root=roots[preset])))
        if len(d) != EVAL_PAIRS[preset]:
            raise RuntimeError(f"eval {preset}: the loader finds {len(d)} pairs")
        gts[preset] = [d[i]["relt_pose"] for i in range(len(d))]
    setup_s = time.time() - t0

    lines, records = [], {}
    own = merge_stage_checkpoints({s: os.path.join(train_dir, s, "best.pth")
                                   for s in STAGES})
    for preset, flag, weights, want in (
            ("3DMatch", "--torch-weights", snapshots["3DMatch"][0],
             snapshots["3DMatch"][1]),
            ("3DMatch", "--weights", train_dir, own),
            ("KITTI", "--torch-weights", snapshots["KITTI"][0],
             snapshots["KITTI"][1])):
        line, calls = eval_run(dev, preset, roots[preset], flag, weights,
                               os.path.join(base, f"log_{preset}{flag}"),
                               gts[preset], want)
        lines.append(line)
        records[(preset, flag)] = calls

    # the 3DMatch tree through the plain versions: the same keypoints and
    # mutual counts, the pose within 1e-4, pair by pair
    out, plain, counts, _ = run_entry(
        ["--config", "3DMatch", "--data-root", roots["3DMatch"],
         "--torch-weights", snapshots["3DMatch"][0], "--log-dir",
         os.path.join(base, "log_plain"), "--device", str(dev)], plain=True)
    if any(counts.values()) or len(plain) != EVAL_PAIRS["3DMatch"]:
        raise RuntimeError(f"eval plain: launches {counts}, {len(plain)} pairs")
    errs = []
    for k, p in zip(records[("3DMatch", "--torch-weights")], plain):
        rk, rp = k["result"], p["result"]
        err = float((rk.pose - rp.pose).abs().max())
        if (not torch.equal(rk.kpts, rp.kpts)
                or not torch.equal(rk.kpt_valid, rp.kpt_valid)
                or int(rk.num_mutual) != int(rp.num_mutual) or err > 1e-4):
            raise RuntimeError(f"eval plain: kernel and plain paths disagree: "
                               f"mutual {int(rk.num_mutual)} vs "
                               f"{int(rp.num_mutual)}, pose {err}")
        errs.append(err)
    check = {"path": "eval 3DMatch", "pairs": len(errs), "kpts_equal": True,
             "pose_max_abs_err": errs}
    print(json.dumps({"plain_eval_check": check}))
    return {"setup_s": setup_s, "runs": lines, "plain_check": check,
            "roots": roots}


def presets_path(dev, roots: dict) -> dict:
    """Three more presets through the test entry point at full width, one
    pair each, with reference-format snapshots of seeded random weights:
    ThreeD2ETH over an ETH tree written here (scale 5), KITTI2ThreeD over
    the eval 3DMatch tree with 3DLoMatch ground truth for its low-overlap
    pair (0, 2) (scale 0.1167, ``keypts_th = 0``, IRLS), ThreeD2KITTI over
    the eval KITTI tree (its 16384-point level 1 overflows: the warnings of
    ``prepare_pair`` are counted)."""
    import warnings
    import numpy as np
    import torch
    from buffer_tpu_torch.config import make_cfg
    from buffer_tpu_torch.eval import metrics
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.scripts.test import make_dataset
    base = os.path.dirname(roots["3DMatch"])
    t0 = time.time()
    eth = os.path.join(base, "ETH")
    write_eth_tree(eth, 25)
    scene = sorted(os.listdir(os.path.join(roots["3DMatch"], "test", "3DMatch",
                                           "fragments")))[0]
    lodir = os.path.join(roots["3DMatch"], "test", "3DLoMatch", scene)
    os.makedirs(lodir)
    gt = os.path.join(roots["3DMatch"], "test", "3DMatch", "gt_result", scene)
    keys, traj = metrics.read_trajectory(os.path.join(gt, "gt.log"))
    pick = [k for k, key in enumerate(keys) if (int(key[0]), int(key[1])) == (0, 2)]
    write_redwood(os.path.join(lodir, "gt.log"), [(0, 2)], traj[pick],
                  len(EVAL_SLABS))
    write_redwood(os.path.join(lodir, "gt.info"), [(0, 2)],
                  [100.0 * np.eye(6)], len(EVAL_SLABS))
    setup_s = time.time() - t0
    lines = []
    for preset, root, extra in (("ThreeD2ETH", eth, ()),
                                ("KITTI2ThreeD", roots["3DMatch"], ()),
                                ("ThreeD2KITTI", roots["KITTI"],
                                 ("--max-pairs", "1"))):
        c = make_cfg(preset)
        c = c.replace(data=dataclasses.replace(c.data, root=root))
        ds = make_dataset(c)
        gts = [ds[i]["relt_pose"] for i in range(EVAL_PAIRS[preset])]
        sd = BufferModel(c, seed=EVAL_SNAPSHOT_SEED).state_dict()
        d = os.path.join(base, f"snapshot_{preset}")
        for stage in STAGES:
            os.makedirs(os.path.join(d, stage))
            torch.save(sd, os.path.join(d, stage, "best.pth"))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            line, _ = eval_run(dev, preset, root, "--torch-weights", d,
                               os.path.join(base, f"log_{preset}"), gts, sd,
                               extra, path="presets")
        over = [str(w.message) for w in caught
                if "exceeds static plan" in str(w.message)]
        if preset == "ThreeD2KITTI" and not any("points_l1" in w for w in over):
            raise RuntimeError("presets ThreeD2KITTI: no points_l1 overflow "
                               "warning")
        line = dict(line, scale=c.test.scale, keypts_th=c.point.keypts_th,
                    pose_refine=c.test.pose_refine, points_l1=c.static.points_l1,
                    overflow_warnings=over)
        print(json.dumps({"preset_overflow": {preset: over}}))
        lines.append(line)
    return {"setup_s": setup_s, "runs": lines}


def train_entry_path(dev, preset: str, root: str, out: str) -> dict:
    """``scripts.train.main`` over a training tree at the preset's full
    width: every stage 1 epoch of TRAIN_ENTRY_STEPS steps, then its val
    split.  Every step's launches must equal the preset's table (and each
    val step's); losses finite, no step skipped; only the active stage's
    parameters move and the frozen stages stay whole; ``best.pth`` and a
    val line in ``metrics.jsonl`` for every stage.  Returns the stage lines,
    the trained model and the Ref stage's first batch."""
    import torch
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.scripts import train as entry
    from buffer_tpu_torch.train import trainer
    Trainer = trainer.Trainer
    table = STEP_LAUNCHES[preset]
    name = f"train entry {preset}"
    lines, first = [], {}

    class Recorded(Trainer):
        def step(self, batch, draws):
            first.setdefault(self.stage, (self.cfg, batch))
            (loss, stats), ms, rose = counted(
                lambda: Trainer.step(self, batch, draws),
                f"{name} {self.stage}", table[self.stage])
            if not all(bool(torch.isfinite(v)) for v in stats.values()):
                raise RuntimeError(f"{name} {self.stage}: non-finite {stats}")
            if float(stats["grad_finite"]) != 1.0:
                raise RuntimeError(f"{name} {self.stage}: a step was skipped")
            self.rec["step_ms"].append(ms)
            self.rec["launches_last_step"] = {k: v for k, v in rose.items() if v}
            return loss, stats

        def evaluate(self, it, generator):
            n = []
            before = cuda.launch_counts()
            t0 = time.perf_counter()
            res = Trainer.evaluate(self, (n.append(b) or b for b in it),
                                   generator)
            torch.cuda.synchronize()
            self.rec["val_s"] = time.perf_counter() - t0
            after = cuda.launch_counts()
            check_launches(f"{name} {self.stage} val",
                           {k: after[k] - before[k] for k in after},
                           {k: v * len(n) for k, v in table[self.stage].items()})
            self.rec["val_pairs"] = len(n)
            if not n or not all(math.isfinite(v) for v in res.values()):
                raise RuntimeError(f"{name} {self.stage}: val {len(n)} pairs, "
                                   f"{res}")
            return res

        def fit(self, train_iter_fn, val_iter_fn, generator):
            self.rec = {"step_ms": []}
            before = {s: state_of(self.model, s) for s in STAGES}
            torch.cuda.reset_peak_memory_stats()
            model = Trainer.fit(self, train_iter_fn, val_iter_fn, generator)
            peak = torch.cuda.max_memory_allocated()
            after = {s: state_of(self.model, s) for s in STAGES}
            moved = [k for k, v in after[self.stage].items()
                     if "running" not in k and "num_batches" not in k
                     and not torch.equal(v, before[self.stage][k])]
            frozen = [s for s in STAGES if s != self.stage and any(
                not torch.equal(v, before[s][k]) for k, v in after[s].items())]
            ms = self.rec["step_ms"]
            if len(ms) != TRAIN_ENTRY_STEPS or not moved or frozen:
                raise RuntimeError(f"{name} {self.stage}: {len(ms)} steps, "
                                   f"{len(moved)} parameters moved, frozen "
                                   f"stages changed: {frozen}")
            line = {"path": name, "stage": self.stage, "steps": len(ms),
                    "first_step_ms": ms[0],
                    "ms_per_step": sum(ms[1:]) / len(ms[1:]), "step_ms": ms,
                    "val_pairs": self.rec["val_pairs"],
                    "val_s_with_prep": self.rec["val_s"],
                    "peak_mem_bytes": peak, "params_moved": len(moved),
                    "launches_last_step": self.rec["launches_last_step"],
                    "best": self.best}
            print(json.dumps(line))
            lines.append(line)
            return model

    cuda.reset_launches()
    t0 = time.time()
    trainer.Trainer = Recorded
    try:
        model = entry.main(["--config", preset, "--data-root", root, "--out", out,
                            "--epochs", "1", "--max-iter", str(TRAIN_ENTRY_STEPS),
                            "--device", str(dev)])
    finally:
        trainer.Trainer = Trainer
    wall = time.time() - t0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        logged = [json.loads(ln) for ln in f]
    for stage in STAGES:
        if not os.path.exists(os.path.join(out, stage, "best.pth")) or not any(
                ln["split"] == "val" and ln["stage"] == stage for ln in logged):
            raise RuntimeError(f"{name} {stage}: no best.pth or val line")
    return {"stages": lines, "wall_s": wall, "launches": cuda.launch_counts(),
            "model": model, "first": first}


def train_entry_paths(dev, kitti_gen) -> dict:
    """The train entry over a 3DMatch and a KITTI training tree written into
    ``build/train_entry/`` (afresh: KITTI's ICP cache lives in its tree,
    filled here before the runs), then one KITTI Ref step with the kernels
    against its plain-version twin."""
    import numpy as np
    from buffer_tpu_torch.config import make_cfg
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.scripts.train import make_dataset
    base = str(cuda.BUILD_DIR / "train_entry")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.time()
    roots = {"3DMatch": os.path.join(base, "ThreeDMatch"),
             "KITTI": os.path.join(base, "KITTI")}
    write_threedmatch_train_tree(roots["3DMatch"], 31)
    write_kitti_train_tree(roots["KITTI"], 32)
    kcfg = make_cfg("KITTI")
    kcfg = kcfg.replace(data=dataclasses.replace(kcfg.data, root=roots["KITTI"]))
    mined = {}
    for split in ("train", "val"):
        ds = make_dataset(kcfg.with_stage("Ref"), split, np.random.RandomState(0))
        mined[split] = list(ds.files)
        for i in range(len(ds)):
            ds[i]                       # the ICP ground truth, cached
    if len(mined["train"]) < TRAIN_ENTRY_STEPS or not mined["val"]:
        raise RuntimeError(f"train entry KITTI: mined pairs {mined}")
    setup_s = time.time() - t0
    runs = {p: train_entry_path(dev, p, roots[p], os.path.join(base, f"out_{p}"))
            for p in ("3DMatch", "KITTI")}
    kcfg_ref, batch = runs["KITTI"]["first"]["Ref"]
    check = plain_train_check("Ref", runs["KITTI"]["model"], kcfg_ref, batch,
                              make_train_draws(kcfg_ref, kitti_gen, dev), dev,
                              os.path.join(base, "plain"), path="train entry KITTI")
    return {"setup_s": setup_s, "mined_kitti": mined, "plain_train_check": check,
            **{p: {k: v for k, v in r.items() if k not in ("model", "first")}
               for p, r in runs.items()}}


def ttr_path(dev) -> dict:
    """``scripts.train_then_register.main`` at TTR_ARGS (a plumbing gate; no
    recall bar): every held-out pair launches the kernels of small_cfg's
    dispatch (counts read around each call of its registration program,
    ``make_register_fn`` with intermediates); recall and
    diagnosis finite; the JSON record written."""
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.pipeline import registration
    from buffer_tpu_torch.scripts import train_then_register as ttr
    base = str(cuda.BUILD_DIR / "ttr_smoke")
    shutil.rmtree(base, ignore_errors=True)
    rec_path = os.path.join(base, "record.json")
    calls = []
    cuda.reset_launches()
    t0 = time.time()
    with recorded_programs(registration, calls):
        rc = ttr.main([*TTR_ARGS, "--device", str(dev), "--out", base,
                       "--json", rec_path])
    wall = time.time() - t0
    pairs = [c["launches"] for c in calls]
    with open(rec_path) as f:
        rec = json.load(f)
    n_eval = int(TTR_ARGS[TTR_ARGS.index("--eval-pairs") + 1])
    if rc != 0 or len(pairs) != n_eval or rec["pairs"] != n_eval:
        raise RuntimeError(f"train_then_register: rc {rc}, {len(pairs)} "
                           f"registrations, record {rec}")
    for rose in pairs:
        check_launches("train_then_register", rose)
    if not (math.isfinite(rec["value"]) and all(
            math.isfinite(v) for v in rec["diagnosis"].values())):
        raise RuntimeError(f"train_then_register: non-finite record {rec}")
    line = {"path": "train_then_register", "args": list(TTR_ARGS),
            "wall_s": wall, "recall": rec["value"],
            "diagnosis": rec["diagnosis"],
            "launches_per_pair": {k: v for k, v in pairs[0].items() if v},
            "launches": cuda.launch_counts()}
    print(json.dumps(line))
    return line


def device_levels_path(dev, cfg, model, pair, draws, host_line) -> dict:
    """The main path's first pair with ``lvl1 = None`` (levels 1 and 2 by
    voxel subsampling on the card, in voxel-key order), twice, the first a
    warm-up: the device levels equal ``prepare_pair``'s as point sets
    within 1e-5 with equal valid counts; the kernel path equals the plain
    path (keypoints, mutual matches, pose within 1e-4); the banded searches
    over the device levels checked bit-equal and scored against the exact
    search; the pyramid stage's span beside the host-levels pair's."""
    import torch
    from buffer_tpu_torch.pipeline.pyramid import device_levels
    path = "3DMatch device levels"
    inputs = pair._replace(lvl1=None, lvl1_mask=None, lvl2=None, lvl2_mask=None)
    counts, *rest = drive(path, model, dev, [inputs, inputs], [draws, draws])
    line = path_line(path, cfg, counts, *rest, 0.0, pair)
    l1, m1, l2, m2 = device_levels(cfg, pair.sds.to(dev), pair.sds_mask.to(dev))
    valid = {}
    for lvl, got, gmask, want, wmask in ((1, l1, m1, pair.lvl1, pair.lvl1_mask),
                                         (2, l2, m2, pair.lvl2, pair.lvl2_mask)):
        for b in range(2):
            a, h = got[b][gmask[b]], want[b][wmask[b]].to(dev)
            if len(a) != len(h) or not len(a):
                raise RuntimeError(f"{path}: level {lvl} holds {len(a)} points "
                                   f"on the card, {len(h)} on the host")
            d = torch.cdist(a, h, compute_mode="donot_use_mm_for_euclid_dist")
            far = max(float(d.min(dim=1).values.max()),
                      float(d.min(dim=0).values.max()))
            if far > 1e-5:
                raise RuntimeError(f"{path}: level {lvl} points {far} from the "
                                   "host levels")
            valid.setdefault(f"lvl{lvl}", []).append(len(a))
    res_k, inter_k, calls = recorded_run(model, dev, inputs, draws)
    check = plain_path_check(path, model, dev, inputs, draws, (res_k, inter_k))
    _, rows = banded_entries(calls, cfg, time_plain=False)
    recall = [{"kernel": r["kernel"], "Q": r["Q"], "S": r["S"],
               "score": r["score"]} for r in rows]
    out = dict(line, device_valid_points=valid, plain_check=check,
               banded_recall=recall,
               pyramid_ms=line["stage_ms"]["pyramid"],
               host_levels_pyramid_ms=host_line["stage_ms"]["pyramid"])
    print(json.dumps({"device_levels": {k: out[k] for k in (
        "device_valid_points", "banded_recall", "pyramid_ms",
        "host_levels_pyramid_ms")}}))
    return out


def results_equal(got, want) -> bool:
    """Every field of two ``RegistrationResult``s bit-equal."""
    import torch
    return all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, want))


def profile_call(fn):
    """One call of ``fn`` under ``torch.profiler``: the window opened by
    ``utils.profiling.open_window``, a warm-up call of ``fn`` and, right
    after it, the profiled call, each in a ``record_function`` span, and
    the window closed ``settle`` after the card is idle.  A span's device
    events are those whose correlation id in the exported trace is that of
    a CUDA runtime call inside it (``scripts.analyze_trace.span_events``).
    The warm-up takes the first records that the profiler loses in some
    processes (the spin kernels did not always: in one such process every
    window lost a train-program replay's first banded-kNN pack kernel); a
    line is printed where it did.  Returns (the profiled call's output, its
    kernel count by __global__ name of GLOBALS, all device events it
    launched, its host dispatches, their device ms, the launch counters'
    rise in it)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.scripts.analyze_trace import span_events
    from buffer_tpu_torch.utils.profiling import open_window, settle
    torch.cuda.synchronize()
    rose = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        open_window()
        for span in PROFILE_SPANS:
            before = cuda.launch_counts()
            with torch.profiler.record_function(span):
                out = fn()
            rose[span] = {k: v - before[k]
                          for k, v in cuda.launch_counts().items()}
        settle()
    path = cuda.BUILD_DIR / "profile_call.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    path.unlink()
    names = sorted({n for ns in GLOBALS.values() for n in ns})

    def seen_of(ks):
        return {n: sum(1 for e in ks if re.search(rf"\b{n}\b", e["name"]))
                for n in names}

    warm, ks = (span_events(events, s) for s in PROFILE_SPANS)
    warm_seen = seen_of(warm)
    if not shows(warm_seen, expected(rose[PROFILE_SPANS[0]])):
        print(json.dumps({"profile_warm_up_lost_records": warm_seen,
                          "rose": rose[PROFILE_SPANS[0]]}), flush=True)
    call = next(e for e in prof.events() if e.name == PROFILE_SPANS[1]
                and e.device_type == torch.autograd.DeviceType.CPU)
    dispatches = sum(1 for e in prof.events()
                     if re.fullmatch(DISPATCH_APIS, e.name)
                     and call.time_range.start <= e.time_range.start
                     <= call.time_range.end)
    return (out, seen_of(ks), len(ks), dispatches,
            sum(e["dur"] for e in ks) / 1e3, rose[PROFILE_SPANS[1]])


def expected(rose: dict) -> dict:
    """The kernel counts by __global__ name that the launch counters' rise
    ``rose`` stands for."""
    want = {}
    for k, v in rose.items():
        for name in GLOBALS[k]:
            want[name] = want.get(name, 0) + v
    return want


def shows(seen: dict, want: dict) -> bool:
    """A profile's kernel counts ``seen`` are ``want``'s, and no other
    kernel of GLOBALS appears."""
    return {n: c for n, c in seen.items() if c or n in want} == want


def profiled_launches(path: str, fn, ok=lambda out: True):
    """``profile_call(fn)`` held to the launch counters: the profile's
    ``__global__`` names show each kernel as often as its counter rose in
    the call, and no other, and ``ok(fn's output)`` holds.  A profile that
    shows fewer kernels than the counters, and none more, lost records: it
    is taken again, up to PROFILE_ATTEMPTS profiles.  Returns (the first
    five of ``profile_call``'s tuple, the counters' rise, the profiles
    taken)."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        prof = profile_call(fn)
        out, seen, n_kernels, _, kernel_ms, rose = prof
        if not ok(out):
            raise RuntimeError(f"{path}: the profiled call's result differs")
        want = expected(rose)
        if shows(seen, want):
            return prof[:5], rose, attempt
        lost = all(c <= want.get(n, 0) for n, c in seen.items())
        print(json.dumps({"profile_lost_records": path, "attempt": attempt,
                          "seen": seen, "rose": rose,
                          "kernels": n_kernels}), flush=True)
        if not lost:
            break
    raise RuntimeError(f"{path}: the profiled call shows {seen} "
                       f"({n_kernels} kernels, {kernel_ms} ms), its "
                       f"counters rose {rose}")


def program_path(path: str, dev, cfg, model, pairs, draws, eager) -> dict:
    """The compiled program (``make_register_fn``) on a path's pairs and
    draws, every count set to 0 just before and read just after: two
    passes over the pairs (the first warms and captures, the second
    replays), every call launching the path's table and every replay
    bit-equal to ``eager`` (``register_pair``'s results on the same pairs
    and draws); every result still holding its values after the calls that
    follow it; one replay under ``torch.profiler`` showing each kernel as
    often as the counters rose.  Prints warm ms/pair of the program and of
    ``register_pair`` by the host clock (PROGRAM_TIMED calls each, in turn
    over the pairs), the capture seconds, host dispatches a pair (CUDA
    runtime launches and copies, program and eager) and device ms of a
    replay (CUDA events around the call; the profile's kernel ms)."""
    import torch
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.pipeline import registration
    table = PER_PAIR[path.replace(" program", "")]
    fn = registration.make_register_fn(model, device=dev)
    cuda.reset_launches()
    kept, first_ms = [], None
    for n_pass in range(2):
        for i, (inputs, dr) in enumerate(zip(pairs, draws)):
            before = cuda.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(inputs, dr)
            torch.cuda.synchronize()
            if first_ms is None:
                first_ms = 1e3 * (time.perf_counter() - t0)
            after = cuda.launch_counts()
            check_launches(path, {k: after[k] - before[k] for k in after}, table)
            if not results_equal(res, eager[i]):
                raise RuntimeError(f"{path}: pass {n_pass} pair {i} differs "
                                   "from register_pair")
            kept.append((res, i))
    counts = cuda.launch_counts()
    if counts != {k: 2 * len(pairs) * table.get(k, 0) for k in counts}:
        raise RuntimeError(f"{path}: launches {counts} over {2 * len(pairs)} "
                           "calls")
    for res, i in kept:
        if not results_equal(res, eager[i]):
            raise RuntimeError(f"{path}: a result changed in a later call")
    (program,) = fn.programs.values()

    def timed(call, n):
        ms = []
        for k in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(pairs[k % len(pairs)], draws[k % len(pairs)])
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        return ms

    fn_ms = timed(fn, PROGRAM_TIMED)
    eager_ms = timed(lambda p, d: registration.register_pair(model, p, d,
                                                             device=dev),
                     PROGRAM_TIMED)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn(pairs[0], draws[0])
    end.record()
    end.synchronize()
    replay_ms = start.elapsed_time(end)
    (res, seen, n_kernels, dispatches, kernel_ms), _, attempts = \
        profiled_launches(path, lambda: fn(pairs[0], draws[0]),
                          lambda out: results_equal(out, eager[0]))
    _, _, eager_kernels, eager_dispatches, eager_kernel_ms, _ = profile_call(
        lambda: registration.register_pair(model, pairs[0], draws[0],
                                           device=dev))
    line = {"path": path, "pairs": len(pairs), "calls": 2 * len(pairs),
            "bit_equal_to_eager": True, "first_call_ms": first_ms,
            "capture_s": program.capture_s,
            "ms_per_pair": sum(fn_ms) / len(fn_ms), "per_call_ms": fn_ms,
            "eager_ms_per_pair": sum(eager_ms) / len(eager_ms),
            "eager_per_call_ms": eager_ms,
            "dispatches_per_pair": dispatches,
            "eager_dispatches_per_pair": eager_dispatches,
            "replay_device_ms": replay_ms, "replay_kernel_ms": kernel_ms,
            "eager_kernel_ms": eager_kernel_ms,
            "kernels_per_replay": n_kernels, "eager_kernels": eager_kernels,
            "profiled_kernels": {n: c for n, c in seen.items() if c},
            "profiles_taken": attempts,
            "launches": counts, "tails": sorted(program.tails)}
    print(json.dumps(line))
    return line


def program_variants(dev, cfg, pairs, draws, smodel, sampled_eager) -> dict:
    """One 3DMatch pair through programs of their own, each warmed and
    captured, then replayed and held bit-equal to ``register_pair`` under
    its config: the boost tail (``low_match_th`` above any mutual count),
    the base tail (``low_match_th = 0``), ``fused_desc = False`` and device
    levels (``lvl1 = None``).  Then the model's weights: loaded in place
    (``load_state_dict``) the program replays, a replaced parameter makes
    the next call raise."""
    import torch
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.pipeline import registration
    out = {}

    def held(name, model, inputs, dr, want=None):
        fn = registration.make_register_fn(model, device=dev)
        fn(inputs, dr)
        got = fn(inputs, dr)
        if want is None:
            want = registration.register_pair(model, inputs, dr, device=dev)
        if not results_equal(got, want):
            raise RuntimeError(f"program {name}: the replay differs from "
                               "register_pair")
        (program,) = fn.programs.values()
        out[name] = {"num_mutual": int(got.num_mutual),
                     "boost": registration.boost_taken(model.cfg,
                                                       got.num_mutual),
                     "capture_s": program.capture_s}
        return fn

    for name, th in (("boost tail", 10 ** 6), ("base tail", 0)):
        c = cfg.replace(static=dataclasses.replace(cfg.static, low_match_th=th))
        model = BufferModel(c, seed=0).to(dev).eval()
        fn = held(name, model, pairs[0], draws[0])
        if out[name]["boost"] != (th > 0):
            raise RuntimeError(f"program {name}: took the other tail")
    held("fused_desc=False", smodel, pairs[0], draws[0], sampled_eager)
    levels = pairs[0]._replace(lvl1=None, lvl1_mask=None, lvl2=None,
                               lvl2_mask=None)
    held("device levels", BufferModel(cfg, seed=0).to(dev).eval(), levels,
         draws[0])

    # weights: in place carries over; a new tensor raises (model: the base
    # tail's)
    want = registration.register_pair(model, pairs[0], draws[0], device=dev)
    model.load_state_dict(BufferModel(model.cfg, seed=0).state_dict())
    if not results_equal(fn(pairs[0], draws[0]), want):
        raise RuntimeError("program: a replay after load_state_dict differs")
    conv = model.Desc.pnt_layer[0]
    weight = conv.weight
    conv.weight = torch.nn.Parameter(weight.detach().clone())
    try:
        fn(pairs[0], draws[0])
    except RuntimeError as e:
        out["swapped_parameter"] = str(e)
    else:
        raise RuntimeError("program: a replaced parameter did not raise")
    finally:
        conv.weight = weight
    if not results_equal(fn(pairs[0], draws[0]), want):
        raise RuntimeError("program: the restored parameter does not replay")
    print(json.dumps({"program_variants": out}))
    return out


def sync_count(fn):
    """``fn()`` and the host synchronizations it made (CUDA's sync debug
    mode warns on each)."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def unstacked(res, u):
    """Pair ``u`` of a result with a leading U axis."""
    return type(res)(*(t[u] for t in res))


def overlap_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (window as
    ``profile_call``'s): its kernels' summed device ms, the ms the card had
    at least one of them running (the union of their intervals), the span
    from the first kernel's start to the last one's end, and their ratios
    (kernels side by side; the card's idle share within the span)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from buffer_tpu_torch.utils.profiling import (kernel_events, open_window,
                                                  settle)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        open_window()
        fn()
        settle()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in kernel_events(prof))
    busy, lo, hi = 0.0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    summed = sum(b - a for a, b in spans)
    span = max(b for _, b in spans) - spans[0][0]
    return {"kernels": len(spans), "kernel_ms_summed": summed / 1e3,
            "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "side_by_side": summed / busy, "idle_share": 1 - busy / span}


def unrolled_run(path: str, dev, model, pairs, draws, eager, U: int,
                 table: dict) -> dict:
    """``make_unrolled_register_fn(model, U)`` over ``pairs`` in groups of U
    (the last padded with its last pair, as ``run_eval`` pads), every count
    set to 0 just before and read just after: two passes (the first warms
    and captures, the second replays), every call launching U times the
    table, every pair bit-equal to ``eager`` (``register_pair``'s results,
    which ``program_path`` holds ``make_register_fn``'s to), every result
    holding its values after the calls that follow it, one host
    synchronization a replayed call, a stream and a memory pool a chain.
    Then PROGRAM_TIMED calls over the groups in turn (host clock around
    each synchronized call), one call a group between CUDA events, and the
    first group's call under ``torch.profiler`` (``overlap_profile``).
    Memory, above what was allocated (reserved) before the program, with
    the graphs of the runs before it freed: the peak allocated (the warm-up included), what
    the program holds allocated after its calls, and the reserved rise
    (its graphs' pools)."""
    import gc
    import torch
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.pipeline import registration
    n = len(pairs)
    groups = [list(range(k, min(k + U, n))) for k in range(0, n, U)]
    groups = [g + [g[-1]] * (U - len(g)) for g in groups]
    want_call = {k: U * v for k, v in table.items()}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    base_reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    fn = registration.make_unrolled_register_fn(model, U, device=dev)
    cuda.reset_launches()
    kept, syncs, first_ms = [], [], None
    for n_pass in range(2):
        for g in groups:
            before = cuda.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call = lambda: fn([pairs[i] for i in g], [draws[i] for i in g])
            res, synced = sync_count(call)
            torch.cuda.synchronize()
            if first_ms is None:
                first_ms = 1e3 * (time.perf_counter() - t0)
            after = cuda.launch_counts()
            check_launches(path, {k: after[k] - before[k] for k in after},
                           want_call)
            if n_pass:
                syncs.append(synced)
            for u, i in enumerate(g):
                if not results_equal(unstacked(res, u), eager[i]):
                    raise RuntimeError(f"{path}: pass {n_pass} pair {i} "
                                       f"(slot {u}) differs from "
                                       "register_pair")
            kept.append((res, g))
    if syncs != [1] * len(groups):
        raise RuntimeError(f"{path}: host synchronizations a replayed call "
                           f"{syncs}, expected 1")
    counts = cuda.launch_counts()
    if counts != {k: 2 * len(groups) * want_call.get(k, 0) for k in counts}:
        raise RuntimeError(f"{path}: launches {counts} over "
                           f"{2 * len(groups)} calls")
    for res, g in kept:
        if not all(results_equal(unstacked(res, u), eager[i])
                   for u, i in enumerate(g)):
            raise RuntimeError(f"{path}: a result changed in a later call")
    (program,) = fn.programs.values()
    chains = program.chains
    if (len({c.stream.cuda_stream for c in chains}) != U
            or len({c.pool for c in chains}) != U):
        raise RuntimeError(f"{path}: chains share a stream or a pool")
    args = [([pairs[i] for i in g], [draws[i] for i in g]) for g in groups]
    ms, device_ms = [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for k in range(PROGRAM_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args[k % len(args)])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    for a in args:
        torch.cuda.synchronize()
        start.record()
        fn(*a)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
    overlap = overlap_profile(lambda: fn(*args[0]))
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    reserved = torch.cuda.memory_reserved() - base_reserved
    tails = [sorted({registration.boost_taken(model.cfg, int(r.num_mutual[u]))
                     for u in range(U)}) for r, _ in kept]
    line = {"path": path, "U": U, "pairs": n, "groups": groups,
            "calls": 2 * len(groups), "bit_equal_to_eager": True,
            "first_call_ms": first_ms, "capture_s": program.capture_s,
            "ms_per_pair": sum(ms) / len(ms) / U, "per_call_ms": ms,
            "device_ms_per_call": sum(device_ms) / len(device_ms),
            "device_ms_by_group": device_ms,
            "host_syncs_per_call": 1, "peak_bytes": peak,
            "held_bytes": held, "reserved_bytes": reserved,
            "tails_per_call": tails, "profiled_call": overlap,
            "launches": counts}
    del fn, program, chains, kept
    return line


def unrolled_path(dev, cfg, kcfg, model, kmodel, pairs, kpairs, draws,
                  kdraws, eager, keager) -> dict:
    """The unrolled program (``make_unrolled_register_fn``) at full width:
    3DMatch's 3 pairs at U = 1, 2 and 3, KITTI's 2 at U = 1 and 2 (each
    ``unrolled_run``), then 3DMatch at U = 3 with ``low_match_th`` between
    the pairs' mutual counts, so that one group takes both tails.  Prints a
    line a run and, for each preset, ms/pair and device ms a call at each
    U beside U = 1's (device ms a call against U times U = 1's)."""
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.pipeline import registration
    runs = []
    for name, c, m, ps, ds, want, Us in (
            ("3DMatch", cfg, model, pairs, draws, eager, UNROLL["3DMatch"]),
            ("KITTI", kcfg, kmodel, kpairs, kdraws, keager, UNROLL["KITTI"])):
        lines = []
        for U in Us:
            line = unrolled_run(f"{name} unrolled U={U}", dev, m, ps, ds,
                                want, U, PER_PAIR[name])
            print(json.dumps(line), flush=True)
            lines.append(line)
        one = lines[0]
        print(json.dumps({"unrolled": name, "by_U": [
            {"U": ln["U"], "ms_per_pair": ln["ms_per_pair"],
             "device_ms_per_call": ln["device_ms_per_call"],
             "U_times_U1_device_ms": ln["U"] * one["device_ms_per_call"],
             "capture_s": ln["capture_s"], "peak_bytes": ln["peak_bytes"],
             "reserved_bytes": ln["reserved_bytes"],
             "side_by_side": ln["profiled_call"]["side_by_side"],
             "idle_share": ln["profiled_call"]["idle_share"]}
            for ln in lines]}), flush=True)
        runs.extend(lines)

    # a group that takes both tails: low_match_th at the largest count
    counts = [int(r.num_mutual) for r in eager]
    if min(counts) == max(counts):
        raise RuntimeError(f"unrolled mixed tails: equal counts {counts}")
    mcfg = cfg.replace(static=dataclasses.replace(cfg.static,
                                                  low_match_th=max(counts)))
    mmodel = BufferModel(mcfg, seed=0).to(dev).eval()
    mwant = [registration.register_pair(mmodel, p, d, device=dev)
             for p, d in zip(pairs, draws)]
    U = len(pairs)
    line = unrolled_run(f"3DMatch unrolled U={U} mixed tails", dev, mmodel,
                        pairs, draws, mwant, U, PER_PAIR["3DMatch"])
    if line["tails_per_call"] != [[False, True]] * line["calls"]:
        raise RuntimeError(f"unrolled mixed tails: {line['tails_per_call']}")
    line["low_match_th"], line["num_mutual"] = max(counts), counts
    print(json.dumps(line), flush=True)
    runs.append(line)
    return {"runs": runs}


def script_line(main, argv) -> dict:
    """An entry point's ``main(argv)`` with its standard output kept: a
    return other than 0 raises; returns its last line as JSON."""
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(list(argv))
    finally:
        lines = buf.getvalue().strip().splitlines()
    if rc != 0:
        raise RuntimeError(f"{main.__module__} {argv}: returned {rc}")
    return json.loads(lines[-1])


def rounding_agrees(value: float, ms: float) -> bool:
    """``1000 / value`` equals ``ms`` to their rounding (value to 3
    decimals, ms to 2: the bench's line)."""
    return abs(1e3 / value - ms) <= (0.005 + 1e3 * 0.0005
                                     / (value * (value - 0.0005)) + 1e-9)


def bench_path(dev, programs) -> dict:
    """The benchmark entry point at full size, 3DMatch then KITTI, every
    count set to 0 just before each run and read just after: its one JSON
    line, with bench.py's pairs a call (3DMatch 3 unrolled, KITTI 1); each
    pair of the last timed call bit-equal to ``register_pair`` on the
    bench's pair and its draws, both rebuilt here; one timed replay (and
    every call: the first call's warm-up included) launching a pair's table
    a pair; ``value`` finite and above 0, and ``1000 / value`` equal to
    ``ms_per_pair`` to rounding.  Prints the line and its ms/pair beside
    the program line's of the same preset (other pairs, one a call: not
    gated)."""
    import io
    import torch
    from buffer_tpu_torch import bench
    from buffer_tpu_torch.config import make_cfg
    from buffer_tpu_torch.data.synthetic import bench_pair, lidar_pair
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.pipeline import registration
    program_ms = {p["path"].replace(" program", ""): p["ms_per_pair"]
                  for p in programs}
    out = {}
    for config in ("3DMatch", "KITTI"):
        # keep the last call's results only: recorded_programs would
        # synchronize inside the timed runs
        last = []
        make = registration.make_unrolled_register_fn

        def keeping(model, unroll, device=None, **kw):
            fn = make(model, unroll, device=device, **kw)

            def kept(inputs_list, draws_list):
                res = fn(inputs_list, draws_list)
                last[:] = [model, inputs_list, draws_list, res]
                return res
            kept.programs = getattr(fn, "programs", None)
            return kept

        buf = io.StringIO()
        cuda.reset_launches()
        registration.make_unrolled_register_fn = keeping
        try:
            with contextlib.redirect_stdout(buf):
                rc = bench.main(["--config", config])
        finally:
            registration.make_unrolled_register_fn = make
        counts = cuda.launch_counts()
        lines = buf.getvalue().strip().splitlines()
        if rc != 0 or len(lines) != 1:
            raise RuntimeError(f"bench {config}: returned {rc}, printed "
                               f"{len(lines)} lines")
        print(lines[0], flush=True)
        line = json.loads(lines[0])
        ex = line["extra"]
        value = line["value"]
        if not (math.isfinite(value) and value > 0
                and rounding_agrees(value, ex["ms_per_pair"])):
            raise RuntimeError(f"bench {config}: value {value} pairs/s against "
                               f"{ex['ms_per_pair']} ms/pair")
        static = make_cfg(config).static
        PU = ex["pair_batch"] * ex["pair_unroll"]
        if (ex["pair_batch"], ex["pair_unroll"]) != (static.pair_batch,
                                                     static.pair_unroll):
            raise RuntimeError(f"bench {config}: {ex['pair_batch']} x "
                               f"{ex['pair_unroll']} pairs a call, not the "
                               "preset's")
        table = PER_PAIR[config]
        if ex["launches_per_pair"] != table:
            raise RuntimeError(f"bench {config}: a timed replay launched "
                               f"{ex['launches_per_pair']} a pair, expected "
                               f"{table}")
        check_launches(f"{config} bench", {k: v / (ex["calls"] * PU)
                                           for k, v in counts.items()}, table)
        if (ex["platform"], ex["weights"], ex["config"]) != ("gpu", "random",
                                                             config):
            raise RuntimeError(f"bench {config}: {ex}")
        model, inputs_list, draws_list, res = last
        cfg = model.cfg
        pair, T = (lidar_pair(cfg, 13, dev) if config == "KITTI"
                   else bench_pair(cfg, dev))
        gen = torch.Generator(device=dev).manual_seed(0)
        want_draws = [registration.make_draws(cfg, gen, dev)
                      for _ in range(ex["timed_pairs"])][-PU:]
        if len(inputs_list) != PU or res.pose.shape[0] != PU:
            raise RuntimeError(f"bench {config}: the last call holds "
                               f"{len(inputs_list)} pairs, not {PU}")
        for u, (inputs, draws, wd) in enumerate(zip(inputs_list, draws_list,
                                                    want_draws)):
            for name, a, b in zip((*pair._fields, *draws._fields),
                                  (*inputs, *draws), (*pair, *wd)):
                if not (a is None and b is None or torch.equal(a, b)):
                    raise RuntimeError(
                        f"bench {config}: the timed call's pair {u} {name} "
                        "is not the bench pair's / its draws'")
            want = registration.register_pair(model, pair, wd, device=dev)
            if not results_equal(unstacked(res, u), want):
                raise RuntimeError(f"bench {config}: pair {u} of the last "
                                   "timed call differs from register_pair")
        if int(res.num_mutual[0]) != ex["mutual_matches"]:
            raise RuntimeError(f"bench {config}: the line's mutual count is "
                               "not the last call's first pair's")
        side = {"bench": config, "ms_per_pair": ex["ms_per_pair"],
                "pair_unroll": ex["pair_unroll"],
                "device_ms_per_pair": ex["device_ms_per_pair"],
                "program_line_ms_per_pair": program_ms[config],
                "pairs": "the bench's pair against chip_smoke's own"}
        print(json.dumps(side), flush=True)
        out[config] = {"line": line, "launches": counts, **side}
    return out


def rows_ok(what: str, rows) -> None:
    """Every row's ms finite and above 0."""
    bad = [r for r in rows if not (math.isfinite(r["ms"]) and r["ms"] > 0)]
    if bad:
        raise RuntimeError(f"{what}: rows not finite and above 0: {bad}")


def profiles_path(dev, model, pair, draws) -> dict:
    """The measurement entry points at full width: ``profile_stages`` on
    3DMatch and KITTI (the script holds its chained rows bit-equal to
    ``register_pair`` for both budgets and raises otherwise; here their one
    pass launches the path's table), ``profile_micro`` on 3DMatch (chained
    rows bit-equal to the modules they split), ``profile_train`` on every
    stage with the precision check, ``capture_trace`` and
    ``analyze_trace``: the trace's depth-1 ms an iteration within 5% of a
    profiled replay's kernel ms of the same program on the scripts' own
    pair and draws (``model``, ``pair``, ``draws``: ``profile_stages.
    profile_pair``, bench.py's pair).  Every row finite and above 0."""
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.pipeline import registration
    from buffer_tpu_torch.scripts import (analyze_trace, capture_trace,
                                          profile_micro, profile_stages,
                                          profile_train)
    out = {}
    for config in ("3DMatch", "KITTI"):
        line = script_line(profile_stages.main, ["--config", config])
        if line["chain_bit_equal"] is not True:
            raise RuntimeError(f"profile_stages {config}: rows not bit-equal")
        check_launches(f"{config} stage rows", line["launches_a_pass"],
                       PER_PAIR[config])
        rows_ok(f"profile_stages {config}", line["rows"]
                + [{"name": "kabsch_quat", "ms": line["kabsch_ms"]},
                   {"name": "replay", "ms": line["replay_device_ms"]}])
        print(json.dumps({"profile_stages": config, "rows": {
            r["name"]: r["ms"] for r in line["rows"]}, "sum_ms": line["sum_ms"],
            "replay_device_ms": line["replay_device_ms"],
            "tail_taken": line["tail_taken"], "kabsch_ms": line["kabsch_ms"],
            "kabsch_calls": line["kabsch_calls"]}), flush=True)
        out[f"stages {config}"] = line
    micro = script_line(profile_micro.main, ["--config", "3DMatch"])
    if micro["chain_bit_equal"] is not True:
        raise RuntimeError("profile_micro: rows not bit-equal")
    rows_ok("profile_micro", micro["rows"])
    print(json.dumps({"profile_micro": {r["name"]: r["ms"] for r in micro["rows"]},
                      "cylindrical_ms": micro["cylindrical_ms"],
                      "cost_volume_ms": micro["cost_volume_ms"]}), flush=True)
    out["micro 3DMatch"] = micro
    train = script_line(profile_train.main, ["--stages", ",".join(STAGES),
                                             "--precision-check"])
    rows_ok("profile_train", [{"name": s["stage"], "ms": s["replay_ms"]}
                              for s in train["stages"]])
    if not all(math.isfinite(p["grad_rel_l2"]) for p in train["precision"]):
        raise RuntimeError(f"profile_train: precision {train['precision']}")
    print(json.dumps({"profile_train": {s["stage"]: s["replay_ms"]
                                        for s in train["stages"]},
                      "grad_rel_l2_tf32": {p["stage"]: p["grad_rel_l2"]
                                           for p in train["precision"]}}),
          flush=True)
    out["train 3DMatch"] = train
    trace_dir = str(cuda.BUILD_DIR / "torchtrace_smoke")
    shutil.rmtree(trace_dir, ignore_errors=True)
    cap = script_line(capture_trace.main, ["--out", trace_dir, "--iters", "4"])
    ana = script_line(analyze_trace.main, [cap["trace"], "--iters", "4"])
    fn = registration.make_register_fn(model, device=dev)
    for _ in range(2):
        fn(pair, draws)
    kernel_ms = profile_call(lambda: fn(pair, draws))[4]
    ratio = ana["ms_per_iter"] / kernel_ms
    if not (kernel_ms > 0 and abs(ratio - 1) <= 0.05):
        raise RuntimeError(f"analyze_trace: {ana['ms_per_iter']} ms an "
                           f"iteration against a replay's {kernel_ms} kernel ms")
    print(json.dumps({"analyze_trace": {
        "depth1_ms_per_iter": ana["ms_per_iter"], "events": ana["events"],
        "in_part": ana["in_part"],
        "in_part_ms_per_iter": ana["in_part_ms_per_iter"],
        "late_ms": ana["late_ms"],
        "replay_kernel_ms": kernel_ms, "ratio": ratio,
        "top": [(r["name"][:60], r["ms_per_iter"], r["count_per_iter"])
                for r in ana["rows"][:12]]}}), flush=True)
    out["trace 3DMatch"] = {"capture": cap, "analysis": ana,
                            "replay_kernel_ms": kernel_ms, "ratio": ratio}
    return out


def _cpu(nt):
    """A named tuple of tensors with each on the CPU (payloads of ranks)."""
    return type(nt)(*(None if t is None else t.cpu() for t in nt))


def dp_register_path(dev, cfg, model, pairs, draws, results) -> dict:
    """``make_dp_register`` over the main path's pairs and draws: world 2,
    both ranks on the card (gloo), 2 rounds (the second padded), then timed
    rounds; world 1 (gloo), timed; world 1 under NCCL, one round a pair.
    Every rank's launches around each pair as the main path's table; every
    gathered pose and mutual count bit-equal to the main path's one-process
    ``register_pair`` and equal on every rank.  Prints pairs/s at world 1
    and 2 (``utils/dp_scaling.measure``)."""
    import torch
    from buffer_tpu_torch.utils import dp_scaling
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    pairs, draws = [_cpu(p) for p in pairs], [_cpu(d) for d in draws]
    runs = {}
    for name, world, backend, n, iters in DP_REGISTER_RUNS:
        t0 = time.time()
        ranks = dp_scaling.measure(cfg, state, pairs[:n], draws[:n], world,
                                   backend, dev, iters=iters, warmup=DP_WARMUP,
                                   timeout=DP_TIMEOUT, threads=cpu_threads(dev))
        for r in ranks:
            for rose in r["launches"]:
                check_launches("3DMatch", rose)
            for i in range(n):
                if (not torch.equal(r["pose"][i], results[i].pose.cpu())
                        or int(r["num_mutual"][i]) != int(results[i].num_mutual)):
                    raise RuntimeError(f"dp register {name}: rank {r['rank']}'s "
                                       f"pair {i} differs from one process")
        line = {"path": "dp register 3DMatch", "run": name, "world": world,
                "backend": backend, "pairs": n, "wall_s": time.time() - t0,
                "pairs_per_s": ranks[0]["pairs_per_s"],
                "round_ms": [r["round_ms"] for r in ranks],
                "peak_mem_bytes": [r.get("peak_mem_bytes") for r in ranks],
                "launches_per_pair": {k: v for k, v in
                                      ranks[0]["launches"][0].items() if v}}
        print(json.dumps(line))
        runs[name] = line
    w1, w2 = runs["world 1 gloo"]["pairs_per_s"], runs["world 2 gloo"]["pairs_per_s"]
    scaling = {"pairs_per_s": {"1": w1, "2": w2}, "speedup_2": w2 / w1,
               "iters": DP_ITERS, "backend": "gloo"}
    print(json.dumps({"dp_scaling": scaling}))
    return {"runs": runs, "scaling": scaling}


def cpu_threads(dev):
    """Ranks on the CPU (a rehearsal) run one thread each, as the caller
    must for equal reductions; on the card PyTorch's default."""
    return 1 if dev.type == "cpu" else None


def dp_train_path(dev, cfg, model, batches, gen) -> dict:
    """``make_dp_train_step`` at world 2 on the card (gloo) for Ref and Desc,
    a warm-up step and a step each from the model's state, rank r on the
    main path's pair r, under deterministic algorithms: the active stage's
    parameters and running statistics bit-equal across ranks after each
    step and within 1e-6 of one process's step on the mean gradient (loss
    within 1e-5 relative), the running statistics the mean of the two
    one-pair updates; only the active stage moves; every step's launches
    as ``TRAIN_STEP``.  Prints ms/step and peak memory a rank."""
    import torch
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.train.trainer import make_optimizer, mean_train_step
    from buffer_tpu_torch.utils.dist import launch
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    cpu_batches = [type(b)(_cpu(b.inputs), b.relt_pose.cpu()) for b in batches]
    stages = ("Ref", "Desc")
    draws = {s: [[_cpu(make_train_draws(cfg, gen, dev)) for _ in cpu_batches]
                 for _ in range(DP_TRAIN_STEPS)] for s in stages}
    t0 = time.time()
    ranks = launch("buffer_tpu_torch.utils.dp_jobs:train_job",
                   {"cfg": cfg, "state": state, "stages": list(stages),
                    "batches": [cpu_batches] * DP_TRAIN_STEPS, "draws": draws,
                    "device": str(dev), "deterministic": True, "eager": True}, 2,
                   backend="gloo", device=dev, timeout=DP_TIMEOUT,
                   threads=cpu_threads(dev))
    wall = time.time() - t0
    lines = []
    for stage in stages:
        ref = type(model)(cfg)
        ref.load_state_dict(state)
        ref = ref.to(dev)
        opt, _ = make_optimizer(cfg, ref, stage)
        errs = []
        for i in range(DP_TRAIN_STEPS):
            steps = [r["stages"][stage]["steps"][i] for r in ranks]
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                loss, _ = mean_train_step(ref, opt, stage, cpu_batches,
                                          draws[stage][i], device=dev)
            finally:
                torch.use_deterministic_algorithms(False)
            want = ref.state_dict()
            for st in steps:
                check_launches(f"dp train {stage}", st["launches"],
                               TRAIN_STEP[stage])
                check_launches(f"dp train {stage} eager", st["eager"]["launches"],
                               TRAIN_STEP[stage])
                e = st["eager"]
                if (not tensors_equal(st["loss"], e["loss"])
                        or any(not tensors_equal(v, e["stats"][k])
                               for k, v in st["stats"].items())
                        or any(not tensors_equal(v, e["state"][k])
                               for k, v in st["state"].items())
                        or any(not tensors_equal(a[k], b[k]) for a, b in
                               zip(st["adam"], e["adam"]) for k in a)):
                    raise RuntimeError(f"dp train {stage} step {i}: the program "
                                       "differs from the eager DP step")
                if st["others_changed"] or float(st["stats"]["grad_finite"]) != 1.0:
                    raise RuntimeError(f"dp train {stage}: frozen stages "
                                       f"changed {st['others_changed'][:4]} or "
                                       "a step was skipped")
                if any(not torch.equal(v, steps[0]["state"][k])
                       for k, v in st["state"].items()):
                    raise RuntimeError(f"dp train {stage}: ranks differ")
            err = max(float((v.float() - want[k].cpu().float()).abs().max())
                      for k, v in steps[0]["state"].items()
                      if v.is_floating_point())
            loss_rel = abs(float(steps[0]["loss"]) - float(loss)) / max(
                abs(float(loss)), 1e-30)
            if err > 1e-6 or loss_rel > 1e-5:
                raise RuntimeError(f"dp train {stage} step {i}: {err} from the "
                                   f"one-process mean step (loss {loss_rel})")
            errs.append({"param_max_abs_err": err, "loss_rel_err": loss_rel})
        moved = [k for k, v in ranks[0]["stages"][stage]["steps"][-1]["state"].items()
                 if "running" not in k and "num_batches" not in k
                 and not torch.equal(v, state[k])]
        if not moved:
            raise RuntimeError(f"dp train {stage}: no parameter moved")
        ms = [[st["ms"] for st in r["stages"][stage]["steps"]] for r in ranks]
        eager_ms = [[st["eager"]["ms"] for st in r["stages"][stage]["steps"]]
                    for r in ranks]
        replays = [m[1:] for m in ms]
        program_line = {
            "path": "dp train program", "stage": stage, "world": 2,
            "backend": "gloo", "bit_equal_to_eager_steps": DP_TRAIN_STEPS,
            "first_call_ms": [m[0] for m in ms],
            "ms_per_step": sum(map(sum, replays)) / sum(map(len, replays)),
            "eager_ms_per_step": sum(sum(m[1:]) for m in eager_ms)
            / sum(len(m[1:]) for m in eager_ms),
            "step_ms": ms, "eager_step_ms": eager_ms}
        print(json.dumps(program_line))
        line = {"path": "dp train 3DMatch", "stage": stage, "world": 2,
                "backend": "gloo", "step_ms": ms,
                "ms_per_step": sum(m[-1] for m in ms) / len(ms),
                "peak_mem_bytes": [r["stages"][stage]["peak_mem_bytes"]
                                   for r in ranks],
                "params_moved": len(moved), "one_process": errs,
                "losses": [float(st["loss"]) for st in
                           ranks[0]["stages"][stage]["steps"]],
                "program": program_line}
        print(json.dumps(line))
        lines.append(line)
    return {"stages": lines, "wall_s": wall}


def dp_eval_path(dev, roots: dict, one: dict) -> dict:
    """The test entry point as 2 ranks with the ``torchrun`` variables
    (gloo: both ranks on the card) over the eval phase's 3DMatch tree and
    snapshot: every rank's recall, TE, RE and pairs, and rank 0's est.log,
    equal the eval phase's one-process run."""
    from buffer_tpu_torch.utils.dist import launch
    base = os.path.dirname(roots["3DMatch"])
    log_dir = os.path.join(base, "log_dp")
    t0 = time.time()
    ranks = launch("buffer_tpu_torch.scripts.test:main",
                   ["--config", "3DMatch", "--data-root", roots["3DMatch"],
                    "--torch-weights", os.path.join(base, "snapshot_3DMatch"),
                    "--log-dir", log_dir, "--dist-backend", "gloo",
                    "--device", dev.type], 2, device=dev, timeout=DP_TIMEOUT,
                   threads=cpu_threads(dev))
    wall = time.time() - t0
    same = lambda a, b: a == b or (math.isnan(a) and math.isnan(b))
    for r in ranks:
        for k in ("recall", "TE", "RE", "pairs", "registration_recall"):
            if not same(r[k], one[k]):
                raise RuntimeError(f"dp eval: {k} {r[k]}, one process {one[k]}")
    scene = sorted(os.listdir(log_dir))
    one_dir = os.path.join(base, "log_3DMatch--torch-weights")
    for sc in scene:
        with open(os.path.join(log_dir, sc, "est.log")) as f, \
                open(os.path.join(one_dir, sc, "est.log")) as g:
            if f.read() != g.read():
                raise RuntimeError(f"dp eval: est.log of {sc} differs")
    if scene != sorted(os.listdir(one_dir)):
        raise RuntimeError(f"dp eval: scenes {scene}")
    line = {"path": "dp eval 3DMatch", "world": 2, "backend": "gloo",
            "pairs": ranks[0]["pairs"], "wall_s": wall,
            "model_ms_per_round": 1e3 * ranks[0]["model_time"],
            "data_ms_per_pair": 1e3 * ranks[0]["data_time"],
            "one_process_model_ms_per_pair": one["model_ms_per_pair"],
            "recall": ranks[0]["recall"]}
    print(json.dumps(line))
    return line


def synthetic_path(roots: dict) -> dict:
    """``scripts.synthetic_eval.main`` with the eval phase's seeded snapshots:
    2 + 2 rooms (high and low overlap), 2 KITTI scenes, and one room with
    ``--exact``; the GT cross-check's gates pass, every pair launches its
    path's kernels (counts read around each call of the script's
    ``make_register_fn`` program), the JSON record's buckets agree with the
    per-pair lines.  Prints each record and ms/pair (host clock around each
    synchronized call, the first, with warm-up and capture, left out)."""
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.pipeline import registration
    from buffer_tpu_torch.scripts import synthetic_eval
    base = os.path.join(os.path.dirname(os.path.dirname(roots["3DMatch"])),
                        "synth_smoke")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    snaps = os.path.dirname(roots["3DMatch"])
    lines = []

    for name, preset, extra, n_pairs, table in (
            ("3DMatch", "3DMatch", ["--pairs", "2", "--low-pairs", "2"], 4,
             PER_PAIR["3DMatch"]),
            ("KITTI", "KITTI", ["--pairs", "2"], 2, PER_PAIR["KITTI"]),
            ("3DMatch --exact", "3DMatch",
             ["--pairs", "1", "--exact", "--buckets", "high"], 1,
             SYNTH_EXACT_PAIR)):
        records = []
        rec_path = os.path.join(base, f"{name.replace(' ', '')}.json")
        pp_path = rec_path + "l"
        cuda.reset_launches()
        t0 = time.time()
        with recorded_programs(registration, records):
            rc = synthetic_eval.main(
                ["--config", preset, *extra, "--torch-weights",
                 os.path.join(snaps, f"snapshot_{preset}"), "--json", rec_path,
                 "--per-pair-json", pp_path])
        wall = time.time() - t0
        calls = [(r["ms"], r["launches"]) for r in records]
        with open(rec_path) as f:
            (rec,) = [json.loads(ln) for ln in f]
        with open(pp_path) as f:
            per_pair = [json.loads(ln) for ln in f]
        if rc != 0 or len(calls) != n_pairs or len(per_pair) != n_pairs:
            raise RuntimeError(f"synthetic eval {name}: rc {rc}, {len(calls)} "
                               f"registrations, {len(per_pair)} records")
        for _, rose in calls:
            check_launches(f"synthetic eval {name}", rose, table)
        for bucket, b in rec["buckets"].items():
            pp = [p for p in per_pair if p["bucket"] == bucket]
            if b["pairs"] != len(pp) or b["recall"] != round(
                    float(sum(p["ok"] for p in pp)) / len(pp), 4):
                raise RuntimeError(f"synthetic eval {name}: bucket {bucket} "
                                   f"{b} disagrees with its pairs {pp}")
        ms = [c[0] for c in calls]
        line = {"path": "synthetic eval", "run": name, "record": rec,
                "per_pair": per_pair, "register_ms": ms,
                "ms_per_pair": sum(ms[1:] or ms) / len(ms[1:] or ms),
                "wall_s": wall,
                "launches_per_pair": {k: v for k, v in calls[0][1].items() if v}}
        print(json.dumps(line))
        lines.append(line)
    return {"runs": lines}


def calibrate_path(cfg, roots: dict) -> dict:
    """``scripts.calibrate.main`` over the eval phase's 3DMatch tree (host
    work): the suggested caps and padded sizes beside the shipped preset's."""
    from buffer_tpu_torch.scripts import calibrate
    t0 = time.time()
    got = calibrate.main(["--config", "3DMatch", "--data-root",
                          roots["3DMatch"]])
    st = cfg.static
    shipped = {"neighbor_caps": list(st.neighbor_caps),
               "pool_caps": list(st.pool_caps),
               "points_l0": st.points_l0, "points_l1": st.points_l1,
               "points_l2": st.points_l2, "raw_points": st.raw_points}
    line = {"path": "calibrate", "suggested": got, "shipped": shipped,
            "wall_s": time.time() - t0}
    print(json.dumps(line))
    return line


def dense_cfg(kcfg, n: int = DENSE_POINTS):
    """The KITTI preset with ``n`` level-0 points (the dense-LiDAR plan)."""
    return kcfg.replace(
        static=dataclasses.replace(kcfg.static, points_l0=n),
        data=dataclasses.replace(kcfg.data, max_numPts=n))


def recorded_calls(fn, names):
    """fn() with every call of the named functions of ``ops.neighbors``
    recorded as (args, kwargs): (fn's result, {name: [(args, kwargs)]})."""
    from buffer_tpu_torch.ops import neighbors
    calls = {name: [] for name in names}
    saved = {name: getattr(neighbors, name) for name in names}

    def recorder(name):
        def call(*args, **kwargs):
            calls[name].append((args, kwargs))
            return saved[name](*args, **kwargs)
        return call

    for name in names:
        setattr(neighbors, name, recorder(name))
    try:
        out = fn()
    finally:
        for name, f in saved.items():
            setattr(neighbors, name, f)
    return out, calls


def nn64(q, s, valid, chunk: int = 4096):
    """The exact 1-NN indices [B, Q] of q [B, Q, 3] over the valid points
    of s [B, S, 3], by float64 ``torch.cdist`` a query chunk at a time."""
    import torch
    far = torch.where(valid[..., None], s, torch.full_like(s, 1e6)).double()
    return torch.cat([torch.cdist(q[:, c:c + chunk].double(), far).min(dim=2)
                      .indices for c in range(0, q.shape[1], chunk)], dim=1)


def peak_mb(fn) -> float:
    """MiB that fn() allocates on the card at its peak, beyond what was
    held before it."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def graph_replay(fn):
    """fn() captured as a CUDA graph after a warm-up call on a side stream,
    then replayed: (the replay's outputs, the warm-up's)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out, eager


def last_modules_path(dev, cfg, kcfg, model, pair, draws, pose_gt, eager,
                      inter) -> dict:
    """The modules the port added last, at full width on the card:

    * the dense-LiDAR pair (``dense_cfg``: KITTI with 81920 level-0
      points; ``lidar_pair`` seed KITTI_SEED, its own draws) through
      ``register_pair`` and three calls of ``make_register_fn`` (warm-up
      and capture, two replays): the launches KITTI's less the banded-kNN
      launches the fallback took, the fallback taking the level-0 kNN and
      pool 0, every program result bit-equal to the eager one; its FPS
      (16 CTAs of 320 threads) and banded 1-NN calls bit-equal to their
      plain versions;
    * the fallbacks at that shape: each ``radius_knn_banded`` call of the
      pair scored against the exact dense search (recall > RECALL_KNN);
      ``nearest_banded`` at Q = S = 81920 (the level-0 points moved by
      NN_JITTER noise, against themselves) agreeing with the exact 1-NN
      (``torch.cdist`` in float64) on > AGREE_NN1 of the
      queries, and bit-equal as a captured CUDA graph's replay; ms by CUDA
      events and peak memory of each;
    * ``describe_cloud`` on the main path's pair (both clouds, the pair's
      keypoints and axes, and without axes): launches DESCRIBE_CLOUD a
      call, desc and equi within 1e-5 of ``describe_both``'s (``inter``),
      R within 1e-6, and within the SPT's 2e-5 of its plain-version run;
    * ``estimate_normals`` of the pair's level-0 clouds against the same in
      float64 (|cos| > 1 - 1e-3 on >= 99% of the points), with a viewpoint
      (+-the same normals, each facing it); ``cal_z_axis`` of the first
      cloud's patches against ``torch.linalg.eigh`` in float64 (>= 99% of
      the patches with separated eigenvalues within 1e-4);
    * ``kabsch`` against ``kabsch_quat`` (1e-5) on the pair's inliers under
      its ground-truth pose ``pose_gt``: the valid source keypoints and
      their images (1 mm noise), with seeded weights;
    * the model's weights through ``state_dict_to_variables`` and
      ``save_variables`` into flax msgpack files, read back by
      ``load_file`` (equal arrays) and ``load_jax_model``, whose model
      registers the pair bit-equal to ``eager``.

    Raises on any failed gate; returns the phase's numbers."""
    import numpy as np
    import torch
    from buffer_tpu_torch.compat.from_jax import (load_jax_model,
                                                  state_dict_to_variables)
    from buffer_tpu_torch.core import se3
    from buffer_tpu_torch.core.numerics import full_fp32
    from buffer_tpu_torch.data.synthetic import lidar_pair
    from buffer_tpu_torch.kernels import cuda, fps_cuda, knn_cuda, sites
    from buffer_tpu_torch.models import patch_embedder as pe
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.ops import neighbors, normals
    from buffer_tpu_torch.pipeline import registration
    from buffer_tpu_torch.train import checkpoint
    from buffer_tpu_torch.utils.profiling import card_line
    card = card_line()
    out = {"card": card}

    # ---- the dense-LiDAR pair, eager and through the program ------------
    path = "KITTI dense"
    dcfg = dense_cfg(kcfg)
    st = dcfg.static
    band = st.knn_band
    routes = {"l0 kNN": neighbors.knn_route(st.points_l0, band),
              "l1 kNN": neighbors.knn_route(st.points_l1, band),
              "l2 kNN": neighbors.knn_route(st.points_l2, band),
              "pool 0": neighbors.knn_route(st.points_l0, band),
              "pool 1": neighbors.knn_route(st.points_l1, band),
              "l0 -> l1": neighbors.nearest_route(st.points_l1, band),
              "l1 -> l2": neighbors.nearest_route(st.points_l2, band)}
    n_fallback = sum(r == "fallback" for r in routes.values())
    dmodel = BufferModel(dcfg, seed=0).to(dev)
    t0 = time.time()
    dpair, _ = lidar_pair(dcfg, KITTI_SEED, dev)
    prep_s = time.time() - t0
    ddraws = registration.make_draws(
        dcfg, torch.Generator(device=dev).manual_seed(2), dev)
    table = PER_PAIR[path]
    names = ("radius_knn_banded", "nearest_banded", "banded_nn1_cuda")

    def eager_pair():
        return registration.register_pair(dmodel, dpair, ddraws, device=dev,
                                          return_intermediates=True)

    eager_ms = []
    for _ in range(2):                 # the first a warm-up
        cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (dres, dinter), calls = recorded_calls(eager_pair, names)
        torch.cuda.synchronize()
        eager_ms.append(1e3 * (time.perf_counter() - t0))
        check_launches(path, cuda.launch_counts(), table)
    fell = [(n, tuple(a[0].shape), tuple(a[1].shape)) for n in names[:2]
            for a, _ in calls[n]]
    if len(fell) != n_fallback:
        raise RuntimeError(f"{path}: {len(fell)} fallback calls, routes {routes}")
    if not torch.isfinite(dres.pose).all() or not dres.kpt_valid.any():
        raise RuntimeError(f"{path}: non-finite pose or no keypoints")
    fn = registration.make_register_fn(dmodel, device=dev)
    program_ms = []
    for i in range(3):
        cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(dpair, ddraws)
        torch.cuda.synchronize()
        program_ms.append(1e3 * (time.perf_counter() - t0))
        check_launches(path, cuda.launch_counts(), table)
        if not results_equal(res, dres):
            raise RuntimeError(f"{path}: program call {i} differs from "
                               "register_pair")
    # the kernels at the shapes this plan gives them
    K = dcfg.point.num_keypts
    elig = dpair.sds_mask & (dinter["score"] > dcfg.point.keypts_th)
    ik = fps_cuda.fps_cuda_batched(dpair.sds, elig, K)
    if not (torch.equal(ik, fps_cuda.fps_plain(dpair.sds, elig, K))
            and torch.equal(ik, dinter["kidx"])):
        raise RuntimeError(f"{path}: fps kernel, plain version and the "
                           "pair's keypoints differ")
    fps_dense = {"N": dpair.sds.shape[1], "plan": fps_cuda.fps_plan(
        dpair.sds.shape[1]), "ms": cuda_ms(
        lambda: fps_cuda.fps_cuda_batched(dpair.sds, elig, K), 5)}
    for a, kw in calls["banded_nn1_cuda"]:
        if not all(torch.equal(x, y) for x, y in zip(
                knn_cuda.banded_nn1_cuda(*a, **kw),
                knn_cuda.banded_nn1_plain(*a, **kw))):
            raise RuntimeError(f"{path}: bnn1 kernel and plain differ")
    out["dense_pair"] = {
        "path": path, "points_l0": st.points_l0, "routes": routes,
        "valid_points": {f: [int(m.sum()) for m in getattr(dpair, f)]
                         for f in ("raw_mask", "sds_mask", "lvl1_mask",
                                   "lvl2_mask")},
        "host_prep_s": prep_s, "fallback_calls": fell,
        "launches": table, "kitti_launches": PER_PAIR["KITTI"],
        "fallback_took": {"bknn": PER_PAIR["KITTI"]["bknn"] - table["bknn"]},
        "eager_ms": eager_ms, "program_ms": program_ms,
        "ms_per_pair": program_ms[-1], "program_bit_equal": True,
        "num_mutual": int(dres.num_mutual), "fps": fps_dense,
        "bnn1_calls": [[*a[0].shape[:2], a[1].shape[1]]
                       for a, _ in calls["banded_nn1_cuda"]]}
    print(json.dumps({"last_modules": out["dense_pair"], "card": card}))

    # ---- the fallbacks at full shape -------------------------------------
    r0 = dcfg.data.voxel_size_0 * dcfg.point.conv_radius
    rows = []
    with torch.no_grad(), full_fp32():
        for a, kw in calls["radius_knn_banded"]:
            q, s, sv, k, radius, b = a
            qv = kw["query_valid"]
            run = lambda: neighbors.radius_knn_banded(*a, **kw)
            got = run()
            exact = lambda: neighbors.radius_knn(q, s, sv, k, radius or r0)
            score = knn_recall(got, exact(), qv, None if radius else r0 * r0)
            rows.append({"fn": "radius_knn_banded", "B": q.shape[0],
                         "Q": q.shape[1], "S": s.shape[1], "k": k,
                         "radius": radius, "band": b, "recall": score,
                         "ms": cuda_ms(run, 5), "peak_mb": peak_mb(run),
                         "exact_ms": cuda_ms(exact, 1, warmup=0)})
        s, sv = dpair.sds, dpair.sds_mask
        noise = torch.randn(s.shape, generator=torch.Generator(
            device=dev).manual_seed(3), device=dev)
        q = torch.where(sv[..., None], s + NN_JITTER * noise, s)
        if neighbors.nearest_route(s.shape[1], band) != "fallback":
            raise RuntimeError("nearest: the dense level 0 is not a fallback")
        run = lambda: neighbors.nearest(q, s, sv, band=band, query_valid=sv)
        d, i = run()
        exact = lambda: nn64(q, s, sv)
        agree = float((i == exact())[sv].float().mean())
        (dg, ig), _ = graph_replay(lambda: neighbors.nearest_banded(
            q, s, sv, band, query_valid=sv))
        if not (torch.equal(dg, d) and torch.equal(ig, i)):
            raise RuntimeError("nearest_banded: a graph replay differs")
        rows.append({"fn": "nearest_banded", "B": q.shape[0], "Q": q.shape[1],
                     "S": s.shape[1], "band": band, "agreement": agree,
                     "ms": cuda_ms(run, 5), "peak_mb": peak_mb(run),
                     "exact_ms": cuda_ms(exact, 1, warmup=0),
                     "graph_bit_equal": True})
    for row in rows:
        print(json.dumps({"fallback": row, "card": card}))
    if (min(r["recall"] for r in rows if "recall" in r) <= RECALL_KNN
            or rows[-1]["agreement"] <= AGREE_NN1):
        raise RuntimeError(f"fallbacks below their bars: {rows}")
    out["fallbacks"] = rows

    # ---- describe_cloud on the main path's pair --------------------------
    described = []
    for b, side in ((0, "s"), (1, "t")):
        args = (model, cfg, draws.ball_prio[b], draws.spt_prio, pair.raw[b],
                pair.raw_mask[b], inter["kpts"][b])
        before = cuda.launch_counts()
        d, e, R = registration.describe_cloud(*args, inter["kaxes"][b])
        after = cuda.launch_counts()
        check_launches("describe_cloud", {k: after[k] - before[k]
                                          for k in after}, DESCRIBE_CLOUD)
        errs = {"desc": float((d - inter[side + "_des"]).abs().max()),
                "equi": float((e - inter[side + "_equi"]).abs().max()),
                "R": float((R - inter[side + "_R"]).abs().max())}
        before = cuda.launch_counts()
        with sites.plain_versions():
            dp, ep, _ = registration.describe_cloud(*args, inter["kaxes"][b])
        if cuda.launch_counts() != before:
            raise RuntimeError("describe_cloud: a kernel ran on the plain path")
        errs["plain"] = max(float((d - dp).abs().max()),
                            float((e - ep).abs().max()))
        before = cuda.launch_counts()
        dn, en, _ = registration.describe_cloud(*args)
        after = cuda.launch_counts()
        check_launches("describe_cloud", {k: after[k] - before[k]
                                          for k in after}, DESCRIBE_CLOUD)
        if not (torch.isfinite(dn).all() and torch.isfinite(en).all()):
            raise RuntimeError("describe_cloud without axes: not finite")
        if (errs["desc"] > 1e-5 or errs["equi"] > 1e-5 or errs["R"] > 1e-6
                or errs["plain"] > 2e-5):
            raise RuntimeError(f"describe_cloud ({side}): {errs}")
        described.append(dict(errs, cloud=side, ms=cuda_ms(
            lambda: registration.describe_cloud(*args, inter["kaxes"][b]), 5)))
    out["describe_cloud"] = described
    print(json.dumps({"describe_cloud": described, "card": card}))

    # ---- normals, cal_z_axis, kabsch -------------------------------------
    with torch.no_grad(), full_fp32():
        pts, msk = pair.sds, pair.sds_mask
        n32 = normals.estimate_normals(pts, msk)
        n64 = normals.estimate_normals(pts.double(), msk)
        cos = (n32.double() * n64).sum(-1).abs()[msk]
        vp = torch.tensor([0.0, 0.0, 10.0], device=dev)
        nv = normals.estimate_normals(pts, msk, viewpoint=vp)
        same = ((nv == n32) | (nv == -n32)).all(-1)[msk].all()
        facing = bool(((nv * (vp - pts)).sum(-1)[msk] >= 0).all())
        p = cfg.patch
        patches = pe.extract_patches(pair.raw[:1], pair.raw_mask[:1],
                                     draws.ball_prio[:1], inter["kpts"][:1],
                                     p.des_r, p.num_points_per_patch)[0]
        delta, ref = patches - patches[:, -1:], patches[:, -1]
        z = normals.cal_z_axis(delta, ref)
        lam, vec = torch.linalg.eigh(delta.double().transpose(-1, -2)
                                     @ delta.double())
        z64 = vec[..., 0]
        z64 = torch.where((torch.sum(-z64 * ref.double(), -1) < 0)[:, None],
                          -z64, z64)
        sep = (lam[:, 1] - lam[:, 0]) > 1e-3 * lam[:, 2]
        zdot = (z.double() * z64).sum(-1)[sep]
        # the source keypoints and their images under the ground-truth
        # pose (1 mm noise), weighted by seeded uniforms where valid
        gen = torch.Generator(device=dev).manual_seed(4)
        A = inter["kpts"][0][None]
        B = se3.transform(A, pose_gt.to(A)) + 1e-3 * torch.randn(
            A.shape, generator=gen, device=dev)
        w = inter["kvalid"][0].to(A.dtype)[None] * torch.rand(
            A.shape[:2], generator=gen, device=dev)
        T_svd, T_quat = se3.kabsch(A, B, w), se3.kabsch_quat(A, B, w)
    geometry = {
        "normals_cos_share": float((cos > 1 - 1e-3).float().mean()),
        "normals_viewpoint_same": bool(same), "normals_facing": facing,
        "normals_ms": cuda_ms(lambda: normals.estimate_normals(pts, msk), 3),
        "cal_z_axis_share": float((zdot > 1 - 1e-4).float().mean()),
        "cal_z_axis_separated": int(sep.sum()),
        "kabsch_points": int((w > 0).sum()),
        "kabsch_vs_gt": float((T_svd[0] - pose_gt.to(A)).abs().max()),
        "kabsch_vs_quat": float((T_svd - T_quat).abs().max())}
    print(json.dumps({"geometry": geometry, "card": card}))
    if (geometry["normals_cos_share"] < 0.99 or not same or not facing
            or geometry["cal_z_axis_share"] < 0.99
            or geometry["kabsch_vs_quat"] > 1e-5):
        raise RuntimeError(f"last modules: geometry gates failed: {geometry}")
    out["geometry"] = geometry

    # ---- the JAX trainer's msgpack checkpoints ---------------------------
    mdir = cuda.BUILD_DIR / "last_modules"
    shutil.rmtree(mdir, ignore_errors=True)
    variables = state_dict_to_variables(model.state_dict())
    paths = {s: str(mdir / s / "best.msgpack") for s in STAGES}
    for f in paths.values():
        checkpoint.save_variables(variables, f)
    back = checkpoint.load_file(paths["Desc"])
    flat = lambda t, pre="": ([(pre, t)] if not isinstance(t, dict) else
                              [x for k, v in t.items()
                               for x in flat(v, f"{pre}/{k}")])
    if [k for k, _ in flat(back)] != [k for k, _ in flat(variables)] or not all(
            np.array_equal(a, b) for (_, a), (_, b) in zip(flat(back),
                                                           flat(variables))):
        raise RuntimeError("msgpack: load_file differs from save_variables")
    loaded = load_jax_model(cfg, paths, dev)
    res = registration.register_pair(loaded, pair, draws, device=dev)
    if not results_equal(res, eager):
        raise RuntimeError("msgpack: the loaded model registers the pair "
                           "differently")
    out["msgpack"] = {"files": len(paths), "bytes": os.path.getsize(
        paths["Desc"]), "register_bit_equal": True}
    print(json.dumps({"msgpack": out["msgpack"]}))
    return out, (dcfg, dpair)


def no_mask_path(dev, cfg, pair, dcfg, dpair) -> dict:
    """The banded searches without ``query_valid``, which take no banded
    kernel (as JAX's take no Pallas kernel) but the fallbacks, their
    windows scaled by S / Q: at the 3DMatch level 0 (the main path's first
    pair: the level-0 kNN, Q = S = 30720, and the l0 -> l1 1-NN over
    10240) and the dense-LiDAR level 0 (``dcfg``, ``dpair``: the level-0
    kNN at 81920 and the level-0 points moved by NN_JITTER noise against
    themselves), each at its preset's band (4096).  Each call launches no
    bknn and no bnn1, is bit-equal to ``radius_knn_banded`` /
    ``nearest_banded`` called with ``query_valid=None``, and scores recall
    > RECALL_KNN against the exact search (on the radius prefix, as
    ``banded_entries`` scores the level-0 list) or 1-NN agreement >
    AGREE_NN1 against the float64 exact 1-NN; ms by CUDA events, beside
    the masked call's (the kernels at 3DMatch).  Raises on a failed gate;
    returns the rows."""
    import torch
    from buffer_tpu_torch.core.numerics import full_fp32
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.ops import neighbors
    from buffer_tpu_torch.utils.profiling import card_line
    card = card_line()
    rows = []

    def unlaunched(what, fn):
        cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        rose = {k: n for k, n in cuda.launch_counts().items()
                if k in ("bknn", "bnn1") and n}
        if rose:
            raise RuntimeError(f"no-mask {what}: launched {rose}")
        return out

    def equal(what, got, want):
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"no-mask {what}: differs from the fallback "
                               "called with query_valid=None")

    for path, c, p in (("3DMatch", cfg, pair), ("KITTI dense", dcfg, dpair)):
        st = c.static
        band, k = st.knn_band, max(st.normal_knn, st.neighbor_caps[0])
        r0 = c.data.voxel_size_0 * c.point.conv_radius
        s, sv = p.sds, p.sds_mask
        if path == "3DMatch":
            q, qv, sup, supv = s, sv, p.lvl1, p.lvl1_mask
        else:
            noise = torch.randn(s.shape, generator=torch.Generator(
                device=dev).manual_seed(3), device=dev)
            q, qv = torch.where(sv[..., None], s + NN_JITTER * noise, s), sv
            sup, supv = s, sv
        S, Sn = s.shape[1], sup.shape[1]
        routes = (neighbors.knn_route(S, band, masked=False),
                  neighbors.nearest_route(Sn, band, masked=False))
        if routes != ("fallback", "fallback"):
            raise RuntimeError(f"no-mask {path}: not the fallbacks' shapes")
        with torch.no_grad(), full_fp32():
            knn = lambda: neighbors.radius_knn(s, s, sv, k, None, band=band)
            got = unlaunched(f"{path} kNN", knn)
            equal(f"{path} kNN", got, neighbors.radius_knn_banded(
                s, s, sv, k, None, band, query_valid=None))
            exact = neighbors.radius_knn(s, s, sv, k, r0)
            masked = lambda: neighbors.radius_knn(s, s, sv, k, None, band=band,
                                                  query_valid=sv)
            rows.append({"path": path, "fn": "radius_knn", "B": s.shape[0],
                         "Q": S, "S": S, "k": k, "band": band,
                         "route": neighbors.knn_route(S, band, masked=False),
                         "masked_route": neighbors.knn_route(S, band),
                         "recall": knn_recall(got, exact, sv, r0 * r0),
                         "ms": cuda_ms(knn, 5), "masked_ms": cuda_ms(masked, 5)})
            nn = lambda: neighbors.nearest(q, sup, supv, band=band)
            d, i = unlaunched(f"{path} 1-NN", nn)
            equal(f"{path} 1-NN", (d, i), neighbors.nearest_banded(
                q, sup, supv, band, query_valid=None))
            masked = lambda: neighbors.nearest(q, sup, supv, band=band,
                                               query_valid=qv)
            rows.append({"path": path, "fn": "nearest", "B": q.shape[0],
                         "Q": q.shape[1], "S": Sn, "band": band,
                         "route": neighbors.nearest_route(Sn, band,
                                                          masked=False),
                         "masked_route": neighbors.nearest_route(Sn, band),
                         "agreement": float((i == nn64(q, sup, supv))[qv]
                                            .float().mean()),
                         "ms": cuda_ms(nn, 5), "masked_ms": cuda_ms(masked, 5)})
    for row in rows:
        print(json.dumps({"no_mask": row, "card": card}))
    if (min(r["recall"] for r in rows if "recall" in r) <= RECALL_KNN
            or min(r["agreement"] for r in rows if "agreement" in r)
            <= AGREE_NN1):
        raise RuntimeError(f"no-mask searches below their bars: {rows}")
    return {"card": card, "rows": rows}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    # cuBLAS's deterministic mode (plain_train_check) needs its workspace
    # fixed before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from buffer_tpu_torch.utils.profiling import card_line
    print(card_line())
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    from buffer_tpu_torch.config import kitti_cfg, threedmatch_cfg
    summary = run(torch.device("cuda", 0), threedmatch_cfg(), kitti_cfg(),
                  N_PAIRS, N_KITTI_PAIRS)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"kernels": summary["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev, cfg, kcfg, n_pairs: int, n_kitti: int) -> dict:
    """Build, drive every path, check each against its plain path and
    measure each kernel; returns the summary (raises on any failure)."""
    import torch
    from buffer_tpu_torch.config import unbanded
    from buffer_tpu_torch.data.synthetic import lidar_pair, surface_pair
    from buffer_tpu_torch.kernels import cuda, fps_cuda, geom_cuda
    from buffer_tpu_torch.models import patch_embedder as pe
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.ops import sampling
    from buffer_tpu_torch.pipeline import registration
    from buffer_tpu_torch.utils.profiling import card_line

    t0 = time.time()
    logs = cuda.build_all()
    build_s = time.time() - t0
    phases, mark = {}, [time.time()]

    def lap(name: str) -> None:
        """Wall seconds of the phase that ends here."""
        now = time.time()
        phases[name] = now - mark[0]
        mark[0] = now
        print(json.dumps({"phase_s": {name: phases[name]}}), flush=True)
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln or "entry function" in ln]
             for k, v in logs.items()}
    print(json.dumps({"build_s": build_s, "ptxas": ptxas}))

    p = cfg.patch
    gen = torch.Generator(device=dev).manual_seed(0)

    def pairs_of(c, make, seeds):
        t = time.time()
        made = [make(c, s, dev) for s in seeds]
        return ([m[0] for m in made], [m[1] for m in made],
                [registration.make_draws(c, gen, dev) for _ in made],
                time.time() - t)

    # ---- the main path: the shipped 3DMatch preset ----------------------
    model = BufferModel(cfg, seed=0).to(dev)
    pairs, poses_gt, draws, prep_s = pairs_of(cfg, surface_pair, range(n_pairs))
    counts, *rest = drive("3DMatch", model, dev, pairs, draws)
    main_results = rest[1]
    main_line = path_line("3DMatch", cfg, counts, *rest, prep_s, pairs[0])
    lap("3DMatch")

    # ---- KITTI at full width --------------------------------------------
    kmodel = BufferModel(kcfg, seed=0).to(dev)
    kpairs, kposes_gt, kdraws, kprep_s = pairs_of(
        kcfg, lidar_pair, range(KITTI_SEED, KITTI_SEED + n_kitti))
    kcounts, *rest = drive("KITTI", kmodel, dev, kpairs, kdraws)
    kitti_results = rest[1]
    kitti_line = path_line("KITTI", kcfg, kcounts, *rest, kprep_s, kpairs[0])
    lap("KITTI")

    # ---- the main path's first pair with the levels built on the card ---
    levels = device_levels_path(dev, cfg, model, pairs[0], draws[0], main_line)
    lap("3DMatch device levels")

    # ---- the exact unbanded path of slice 1 -----------------------------
    ucfg = unbanded(cfg)
    umodel = BufferModel(ucfg, seed=0).to(dev)
    upairs, _, udraws, uprep_s = pairs_of(ucfg, surface_pair, [0])
    ucounts, *rest = drive("3DMatch knn_band=0", umodel, dev, upairs, udraws)
    band0_line = path_line("3DMatch knn_band=0", ucfg, ucounts, *rest, uprep_s,
                           upairs[0])

    # ---- the sampled descriptor front (fused_desc = False) --------------
    scfg = cfg.replace(static=dataclasses.replace(cfg.static, fused_desc=False))
    smodel = BufferModel(scfg, seed=0).to(dev)
    scounts, *rest = drive("3DMatch fused_desc=False", smodel, dev, pairs[:2],
                           draws[:2])
    sampled_results = rest[1]
    sampled_line = path_line("3DMatch fused_desc=False", scfg, scounts, *rest,
                             prep_s, pairs[0])

    lap("knn_band=0 and fused_desc=False")

    # ---- the compiled program (make_register_fn) on the same pairs ------
    programs = [program_path("3DMatch program", dev, cfg, model, pairs, draws,
                             main_results),
                program_path("KITTI program", dev, kcfg, kmodel, kpairs,
                             kdraws, kitti_results)]
    variants = program_variants(dev, cfg, pairs, draws, smodel,
                                sampled_results[0])
    lap("3DMatch program and KITTI program")

    # ---- several pairs in one program (make_unrolled_register_fn) -------
    unrolled = unrolled_path(dev, cfg, kcfg, model, kmodel, pairs, kpairs,
                             draws, kdraws, main_results, kitti_results)
    lap("unrolled")

    # ---- the benchmark entry point, 3DMatch and KITTI --------------------
    bench = bench_path(dev, programs)
    lap("bench")

    # ---- the measurement entry points: profiles and traces --------------
    from buffer_tpu_torch.scripts.profile_stages import profile_pair
    ppair, _, pdraws = profile_pair(cfg, dev)
    profiles = profiles_path(dev, model, ppair, pdraws)
    del ppair, pdraws
    lap("profiles")

    # ---- the first pair of each preset with every call recorded ---------
    res_k, inter_k, calls = recorded_run(model, dev, pairs[0], draws[0])
    kres_k, kinter_k, kcalls = recorded_run(kmodel, dev, kpairs[0], kdraws[0])
    # the calls that the knn_band = 0 and fused_desc = False paths make at
    # shapes of their own: the exact 1-NN's l0 -> l1 and l1 -> l2, and the
    # sampled front's ball sampling of both clouds' keypoints
    _, _, ucalls = recorded_run(umodel, dev, upairs[0], udraws[0],
                                ("nearest_cuda",))
    sres_k, sinter_k, scalls = recorded_run(smodel, dev, pairs[0], draws[0],
                                            ("ball_sample_points_cuda",))
    for path, got, want in (
            ("3DMatch knn_band=0", ucalls["nearest_cuda"], "nearest"),
            ("3DMatch fused_desc=False", scalls["ball_sample_points_cuda"],
             "ball_sample_points")):
        if len(got) != PER_PAIR[path][want]:
            raise RuntimeError(f"{path}: {len(got)} recorded {want} calls")

    # ---- the single-cloud FPS entry point -------------------------------
    K = cfg.point.num_keypts
    sds0 = pairs[0].sds[0]
    elig0 = pairs[0].sds_mask[0] & (inter_k["score"][0] > cfg.point.keypts_th)
    cuda.reset_launches()
    fidx, fvalid = sampling.farthest_point_sample(sds0, elig0, K)
    torch.cuda.synchronize()
    fcounts = cuda.launch_counts()
    check_launches("farthest_point_sample", fcounts)
    if int(fvalid.sum()) != min(K, int(elig0.sum())):
        raise RuntimeError("farthest_point_sample: wrong valid count")

    lap("recorded runs and fps_single")

    # ---- the last modules: fallbacks, describe_cloud, normals, se3, msgpack
    last, (dcfg, dpair) = last_modules_path(
        dev, cfg, kcfg, model, pairs[0], draws[0],
        torch.as_tensor(poses_gt[0], device=dev), res_k, inter_k)
    lap("last modules")

    # ---- the banded searches without query_valid -------------------------
    no_mask = no_mask_path(dev, cfg, pairs[0], dcfg, dpair)
    del dpair
    lap("no-mask")

    # ---- stage-sequential training at full width -----------------------
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.train.trainer import TrainBatch, eval_step
    save_dir = str(cuda.BUILD_DIR / "train_smoke")
    shutil.rmtree(save_dir, ignore_errors=True)
    batches = [TrainBatch(inp, torch.as_tensor(T, device=dev))
               for inp, T in zip(pairs[:TRAIN_PAIRS], poses_gt[:TRAIN_PAIRS])]
    tgen = torch.Generator(device=dev).manual_seed(1)
    train = train_path(dev, cfg, batches, save_dir, tgen)
    tmodel = train["model"]
    lap("3DMatch train")

    # ---- plain-path checks ----------------------------------------------
    checks = [plain_path_check("3DMatch", model, dev, pairs[0], draws[0],
                               (res_k, inter_k)),
              plain_path_check("KITTI", kmodel, dev, kpairs[0], kdraws[0],
                               (kres_k, kinter_k)),
              plain_path_check("3DMatch fused_desc=False", smodel, dev,
                               pairs[0], draws[0], (sres_k, sinter_k))]
    tdraws = make_train_draws(cfg, tgen, dev)
    train_checks = [plain_train_check(st, tmodel, cfg, batches[0], tdraws, dev,
                                      save_dir) for st in ("Desc", "Ref")]
    lap("plain-path checks")

    # ---- the compiled training steps, 3DMatch and KITTI ------------------
    kbatches = [TrainBatch(inp, torch.as_tensor(T, device=dev))
                for inp, T in zip(kpairs[:TRAIN_PAIRS], kposes_gt[:TRAIN_PAIRS])]
    train_programs = [
        train_program_path("3DMatch train program", dev, cfg, batches, tgen,
                           save_dir),
        train_program_path("KITTI train program", dev, kcfg, kbatches, tgen,
                           save_dir)]
    adam = adam_check(dev, cfg, tmodel)
    lap("3DMatch train program and KITTI train program")

    # ---- the train entry over written trees, 3DMatch and KITTI ----------
    train_entry = train_entry_paths(dev, tgen)
    lap("train entry")

    # ---- the evaluation path through the test entry point ---------------
    evaluation = eval_path(dev, cfg, kcfg, save_dir)
    lap("eval")
    eval_roots = evaluation.pop("roots")
    presets = presets_path(dev, eval_roots)
    lap("presets")

    # ---- train from scratch, then register (a reduced count) ------------
    ttr = ttr_path(dev)
    lap("train_then_register")

    # ---- the neighbour and ball calls of one (eval) training step -------
    from buffer_tpu_torch.ops import neighbors
    ball_calls, tbnn1_calls = [], []
    with capture(neighbors, "ball_sample_points_cuda", ball_calls), \
            capture(neighbors, "banded_nn1_cuda", tbnn1_calls):
        eval_step(tmodel, "Desc", batches[0], tdraws, 1.05, dev)
    if len(ball_calls) != 1 or len(tbnn1_calls) != 2:
        raise RuntimeError(f"training step: {len(ball_calls)} ball and "
                           f"{len(tbnn1_calls)} banded 1-NN calls")

    # ---- each kernel against its plain version at the main-path inputs --
    kernels, reference = [], {}
    clock = sm_clock_hz()
    floors = {}

    def floor(name, slots, **tests):
        floors[name] = {"slots_a_test": slots, **tests, **{
            "issue_floor_ms" + key[5:]: issue_floor_ms(n, slots, clock)
            for key, n in tests.items()}}

    def entry(kern, launches, err, ms, plain_ms, flops, nbytes, lib_ms,
              **extra):
        b_ms, b_by = bound(flops, nbytes)
        e = {"name": kern.name, "route": "cuda", "source": kern.source,
             "replaces": kern.replaces, "launches": launches,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, **extra}
        print(json.dumps(e))
        kernels.append(e)

    # 1. exact 1-NN: every call of the pair (the l1 -> l2 upsample), and the
    # KITTI pair's and the knn_band = 0 pair's (checked and timed); around
    # the wrapper and around the C launch alone
    def nn_check(args):
        err = 0.0
        for a in args:
            (dk, ik), (dp, ip) = (geom_cuda.nearest_cuda(*a),
                                  geom_cuda.nearest_plain(*a))
            if not torch.equal(ik, ip) or not torch.equal(dk, dp):
                raise RuntimeError("nearest: kernel and plain differ at "
                                   f"{tuple(a[0].shape)} x {tuple(a[1].shape)}")
            err = max(err, float((dk - dp).abs().max()))
        return err

    def nn_launch_ms(a):
        outs = [torch.empty(a[0].shape[:2], device=dev),
                torch.empty(a[0].shape[:2], dtype=torch.int32, device=dev)]
        return cuda_ms(geom_cuda.nearest_launcher(*a, outs), 20)

    nn_tests = lambda args: sum(a[0].shape[0] * a[0].shape[1] * a[1].shape[1]
                                for a in args)
    nn_args, knn_args = calls["nearest_cuda"], kcalls["nearest_cuda"]
    unn_args = ucalls["nearest_cuda"]
    err = max(nn_check(nn_args), nn_check(knn_args), nn_check(unn_args))
    nn_shapes = lambda args: [[*a[0].shape[:2], a[1].shape[1]] for a in args]
    nn_plans = lambda args: [geom_cuda.nearest_plan(
        a[0].shape[0], a[0].shape[1], a[1].shape[1]) for a in args]
    entry(geom_cuda.NEAREST, counts["nearest"], err,
          sum(cuda_ms(lambda a=a: geom_cuda.nearest_cuda(*a), 20) for a in nn_args),
          sum(cuda_ms(lambda a=a: geom_cuda.nearest_plain(*a), 3) for a in nn_args),
          8 * nn_tests(nn_args),
          sum(a[0].numel() * 4 + a[1].numel() * 4 + a[2].numel()
              + a[0].shape[0] * a[0].shape[1] * 8 for a in nn_args),
          sum(cuda_ms(lambda a=a: cdist_nn(*a), 5) for a in nn_args),
          launch_ms=sum(nn_launch_ms(a) for a in nn_args),
          plan=nn_plans(nn_args),
          ms_kitti=sum(cuda_ms(lambda a=a: geom_cuda.nearest_cuda(*a), 20)
                       for a in knn_args),
          launch_ms_kitti=sum(nn_launch_ms(a) for a in knn_args),
          calls_kitti=nn_shapes(knn_args), plan_kitti=nn_plans(knn_args),
          ms_band0=[cuda_ms(lambda a=a: geom_cuda.nearest_cuda(*a), 20)
                    for a in unn_args],
          launch_ms_band0=[nn_launch_ms(a) for a in unn_args],
          calls_band0=nn_shapes(unn_args), plan_band0=nn_plans(unn_args),
          ptxas=ptxas["nearest"])
    floor("nearest", NEAREST_SLOTS, tests=nn_tests(nn_args),
          tests_kitti=nn_tests(knn_args), tests_band0=nn_tests(unn_args))

    # 2. batched FPS on the detector-eligible points, at the 3DMatch pair's
    # shape and (checked and timed, not in the bound) the KITTI pair's
    def fps_check(path, sds, elig, kidx, n):
        ik = fps_cuda.fps_cuda_batched(sds, elig, n)
        ip = fps_cuda.fps_plain(sds, elig, n)
        if not torch.equal(ik, ip):
            raise RuntimeError(f"fps ({path}): kernel and plain indices differ")
        if not torch.equal(ik, kidx):
            raise RuntimeError(f"fps ({path}): not the path's keypoints")
        return float((ik - ip).abs().max())

    sds = pairs[0].sds
    elig = pairs[0].sds_mask & (inter_k["score"] > cfg.point.keypts_th)
    fps_err = fps_check("3DMatch", sds, elig, inter_k["kidx"], K)
    ksds = kpairs[0].sds
    kelig = kpairs[0].sds_mask & (kinter_k["score"] > kcfg.point.keypts_th)
    KK_fps = kcfg.point.num_keypts
    fps_err = max(fps_err, fps_check("KITTI", ksds, kelig, kinter_k["kidx"],
                                     KK_fps))
    B, N = elig.shape
    fps_ms = cuda_ms(lambda: fps_cuda.fps_cuda_batched(sds, elig, K), 5)
    entry(fps_cuda.FPS, counts["fps"], fps_err, fps_ms,
          cuda_ms(lambda: fps_cuda.fps_plain(sds, elig, K), 1),
          B * (K - 1) * N * 9, B * N * 13 + B * K * 4, None,
          per_step_us=1e3 * fps_ms / (K - 1), plan=fps_cuda.fps_plan(N),
          max_active_clusters=fps_cuda.fps_max_active_clusters(
              fps_cuda.fps_plan(N)),
          ms_kitti=cuda_ms(
              lambda: fps_cuda.fps_cuda_batched(ksds, kelig, KK_fps), 5),
          kitti_shape=list(kelig.shape), plan_kitti=fps_cuda.fps_plan(
              kelig.shape[1]), ms_dense=last["dense_pair"]["fps"]["ms"],
          plan_dense=last["dense_pair"]["fps"]["plan"], ptxas=ptxas["fps"])

    # 3. ball sampling of both clouds' patches: timed around the wrapper
    # and around the C launch alone (pack and select, without the wrapper's
    # preparation)
    def ball_launch_ms(kern, args, outs):
        return cuda_ms(geom_cuda.ball_launcher(kern, *args, outs), 10)

    ball_args = (inter_k["kpts"], pairs[0].raw, pairs[0].raw_mask,
                 draws[0].ball_prio, p.des_r, p.num_points_per_patch)
    outk = geom_cuda.ball_sample_planes_cuda(*ball_args)
    outp = geom_cuda.ball_sample_planes_plain(*ball_args)
    for a, b in zip(outk, outp):
        if not torch.equal(a, b):
            raise RuntimeError("ball_sample: kernel and plain outputs differ")
    Bq, Q = ball_args[0].shape[:2]
    Nr, k = pairs[0].raw.shape[1], p.num_points_per_patch
    entry(geom_cuda.BALL, counts["ball_sample"],
          max(float((a.float() - b.float()).abs().max()) for a, b in zip(outk, outp)),
          cuda_ms(lambda: geom_cuda.ball_sample_planes_cuda(*ball_args), 10),
          cuda_ms(lambda: geom_cuda.ball_sample_planes_plain(*ball_args), 2),
          Bq * Q * Nr * 7, Bq * (Nr * 17 + Q * 12 + Q * k * 13), None,
          launch_ms=ball_launch_ms(geom_cuda.BALL, ball_args,
                                   [torch.empty_like(outk[0]) for _ in range(3)]
                                   + [torch.empty_like(outk[3]).view(torch.uint8)]),
          plan=geom_cuda.ball_plan(Bq, Q, Nr // (k // 2), k // 2),
          valid_slots=int(outk[3].sum()), ptxas=ptxas["ball_sample"])
    floor("ball_sample", BALL_SLOTS, tests=Bq * Q * Nr)

    # 4. the fused SPT front of both clouds' keypoints
    kpts = inter_k["kpts"]
    x, y, z = pe.extract_patch_planes(pairs[0].raw, pairs[0].raw_mask,
                                      draws[0].ball_prio, kpts, p.des_r, k)
    planes = tuple(((c - kpts[..., d:d + 1]) / p.des_r).reshape(2 * K, -1)
                   for d, c in enumerate((x, y, z)))
    R_all = torch.cat([inter_k["s_R"], inter_k["t_R"]])
    W_all, b_eff, f0 = pe.fold_point_mlp(model.Desc, p.azi_n)
    spt_args = (W_all, b_eff, f0, draws[0].spt_prio, planes, R_all, p.rad_n,
                p.azi_n, p.ele_n, p.delta / p.rad_n, p.voxel_sample)
    with torch.no_grad():
        spk = geom_cuda.spt_pooled_cuda(*spt_args)
        spp = geom_cuda.spt_pooled_plain(*spt_args)
        spt_err = float((spk - spp).abs().max())
        if spt_err > 2e-5:
            raise RuntimeError(f"spt_pooled: kernel and plain differ by {spt_err}")
        NUSE, S_eff = geom_cuda.spt_layout(k, p.voxel_sample)
        A = p.rad_n * p.ele_n * p.azi_n
        KK = 2 * K
        winners = geom_cuda.spt_valid_winners(planes, R_all, draws[0].spt_prio,
                                              p.rad_n, p.azi_n, p.ele_n,
                                              p.delta / p.rad_n, p.voxel_sample)
        entry(geom_cuda.SPT, counts["spt_pooled"], spt_err,
              cuda_ms(lambda: geom_cuda.spt_pooled_cuda(*spt_args), 10),
              cuda_ms(lambda: geom_cuda.spt_pooled_plain(*spt_args), 2),
              KK * A * S_eff * 7 + winners * 16 * 8 + KK * S_eff * 20,
              KK * S_eff * 12 + KK * 36 + S_eff * 4 + KK * 16 * A * 4
              + A * 48 * 4, None,
              valid_winners=winners, slots=KK * A * NUSE,
              plan=geom_cuda.spt_plan(KK, S_eff, A, NUSE), ptxas=ptxas["spt_pooled"])

    # 5.-6. the banded kNN (both stages) and the banded 1-NN, every call of
    # the pair; the KITTI pair's calls checked, scored and timed (the plain
    # versions there too slow to time)
    from buffer_tpu_torch.kernels import knn_cuda
    sums, rows = banded_entries(calls, cfg)
    ksums, krows = banded_entries(kcalls, kcfg, time_plain=False)
    quality = {"3DMatch": {n: s["score"] for n, s in sums.items()},
               "KITTI": {n: s["score"] for n, s in ksums.items()}}
    print(json.dumps({"banded_quality": quality}))
    if (min(sums["bknn"]["score"]) <= RECALL_KNN
            or min(sums["bnn1"]["score"]) <= AGREE_NN1):
        raise RuntimeError(f"banded search below its bars on 3DMatch: {quality}")
    # the banded 1-NN's calls of a training step: the pyramid's l0 -> l1
    # and the positive-pair sampler's (B = 1), checked and timed
    train_tests, train_ms, train_launch_ms = 0, 0.0, 0.0
    for a in tbnn1_calls:
        got = knn_cuda.banded_nn1_cuda(*a)
        if not all(torch.equal(x, y) for x, y in
                   zip(got, knn_cuda.banded_nn1_plain(*a))):
            raise RuntimeError("bnn1 (training step): kernel and plain differ")
        train_tests += a[0].shape[0] * a[0].shape[1] * 16 * knn_cuda.NSEG
        train_ms += cuda_ms(lambda a=a: knn_cuda.banded_nn1_cuda(*a), 20)
        train_launch_ms += cuda_ms(knn_cuda.bnn1_launcher(
            *a, [torch.empty_like(x) for x in got]), 20)
    topk = topk_library(calls["banded_knn_cuda"], cfg)
    for kern, name in ((knn_cuda.BKNN, "bknn"), (knn_cuda.BNN1, "bnn1")):
        s = sums[name]
        extra = topk if name == "bknn" else {
            "launch_ms": s["launch_ms"], "launch_ms_kitti": ksums[name]["launch_ms"],
            "plan": [r["plan"] for r in rows if r["kernel"] == "bnn1"],
            "launches_train_step": train["stages"][0][
                "launches_last_step"].get("bnn1", 0),
            "ms_train": train_ms, "launch_ms_train": train_launch_ms,
            "calls_train": [[*a[0].shape[:2], a[1].shape[1]] for a in tbnn1_calls]}
        entry(kern, counts[name], 0.0, s["ms"], s["plain_ms"], s["flops"],
              s["bytes"], None, ms_kitti=ksums[name]["ms"],
              calls_kitti=ksums[name]["calls"], ptxas=ptxas[name], **extra)
        if name == "bknn":
            floor("bknn", BKNN_SLOTS, tests=s["tests"],
                  tests_kitti=ksums[name]["tests"])
        else:
            floor("bnn1", BNN1_SLOTS, tests=s["tests"],
                  tests_kitti=ksums[name]["tests"], tests_train=train_tests)
        reference[name] = {"exact_search_ms": s["exact_ms"], "calls": s["calls"],
                           "what": ("ops.neighbors.radius_knn with band=None"
                                    if name == "bknn" else
                                    "chunked torch.cdist + min"),
                           "note": "a different function: the exact search "
                                   "the banded kernel stands in for"}
    print(json.dumps({"exact_search_reference": reference}))

    # 7. single-cloud FPS: row 0 of the batched kernel and the plain version
    ib = fps_cuda.fps_cuda_batched(sds0[None], elig0[None], K)[0]
    ipl = fps_cuda.fps_single_plain(sds0, elig0, K)
    if not (torch.equal(fidx, ib) and torch.equal(fidx, ipl)):
        raise RuntimeError("fps_single: differs from the batched kernel or "
                           "the plain version")
    N1 = sds0.shape[0]
    single_ms = cuda_ms(lambda: sampling.farthest_point_sample(sds0, elig0, K), 5)
    entry(fps_cuda.FPS_SINGLE, fcounts["fps_single"], 0.0, single_ms,
          cuda_ms(lambda: fps_cuda.fps_single_plain(sds0, elig0, K), 1),
          (K - 1) * N1 * 9, N1 * 13 + K * 4, None,
          per_step_us=1e3 * single_ms / (K - 1))

    # 8. the training front's ball sampling: every call of one (eval) step;
    # and the fused_desc = False pair's call (checked and timed)
    def points_check(args):
        flops = nbytes = tests = 0
        for a in args:
            outk = geom_cuda.ball_sample_points_cuda(*a)
            outp = geom_cuda.ball_sample_points_plain(*a)
            if not all(torch.equal(x, y) for x, y in zip(outk, outp)):
                raise RuntimeError("ball_sample_points: kernel and plain differ "
                                   f"at {tuple(a[0].shape)} x {tuple(a[1].shape)}")
            q, sup, k = a[0], a[1], a[5]
            B, Q, N = q.shape[0], q.shape[1], sup.shape[1]
            tests += B * Q * N
            flops += B * Q * N * 7
            nbytes += B * (N * 17 + Q * 12 + Q * k * 13)
        return flops, nbytes, tests

    def points_ms(args, iters):
        return sum(cuda_ms(lambda a=a: geom_cuda.ball_sample_points_cuda(*a),
                           iters) for a in args)

    def points_launch_ms(args):
        return sum(ball_launch_ms(
            geom_cuda.BALL_POINTS, a,
            [torch.empty((*a[0].shape[:2], a[5], 3), device=dev),
             torch.empty(a[0].shape[:2] + (a[5],), dtype=torch.uint8,
                         device=dev)]) for a in args)

    points_plan = lambda args: [geom_cuda.ball_plan(
        a[0].shape[0], a[0].shape[1], a[1].shape[1] // (a[5] // 2), a[5] // 2)
        for a in args]
    sball_calls = scalls["ball_sample_points_cuda"]
    flops, nbytes, tests = points_check(ball_calls)
    *_, tests_sampled = points_check(sball_calls)
    entry(geom_cuda.BALL_POINTS, train["launches"]["ball_sample_points"], 0.0,
          points_ms(ball_calls, 10),
          sum(cuda_ms(lambda a=a: geom_cuda.ball_sample_points_plain(*a), 2)
              for a in ball_calls),
          flops, nbytes, None,
          launch_ms=points_launch_ms(ball_calls), plan=points_plan(ball_calls),
          ms_sampled=points_ms(sball_calls, 10),
          launch_ms_sampled=points_launch_ms(sball_calls),
          calls_sampled=[[*a[0].shape[:2], a[1].shape[1], a[5]]
                         for a in sball_calls],
          plan_sampled=points_plan(sball_calls),
          ptxas=ptxas["ball_sample_points"])
    floor("ball_sample_points", BALL_SLOTS, tests=tests,
          tests_sampled=tests_sampled)
    derived = {"sm_clock_mhz": clock / 1e6, "sms": SMS, "fp32_lanes": LANES,
               "kernels": floors}
    print(json.dumps({"issue_floor": derived}))
    lap("kernels against plain versions")

    # ---- data parallelism over pairs: ranks on the one card -------------
    dp_register = dp_register_path(dev, cfg, model, pairs, draws, main_results)
    lap("dp register 3DMatch")
    dp_train = dp_train_path(dev, cfg, BufferModel(cfg, seed=0), batches, tgen)
    lap("dp train 3DMatch")
    dp_eval = dp_eval_path(dev, eval_roots, evaluation["runs"][0])
    lap("dp eval 3DMatch")

    # ---- the synthetic evaluation and calibration -----------------------
    synthetic = synthetic_path(eval_roots)
    lap("synthetic eval 3DMatch / KITTI")
    calibration = calibrate_path(cfg, eval_roots)
    lap("calibrate")

    return {"card": card_line(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas,
            "paths": [main_line, kitti_line, band0_line, sampled_line],
            "programs": programs, "program_variants": variants,
            "unrolled": unrolled,
            "bench": bench, "last_modules": last, "no_mask": no_mask,
            "profiles": profiles,
            "device_levels": levels, "train_entry": train_entry,
            "presets": presets, "train_then_register": ttr,
            "eval": evaluation,
            "train": train["stages"], "train_launches": train["launches"],
            "plain_train_checks": train_checks,
            "train_programs": train_programs, "adam_check": adam,
            "ball_points_calls": [{"B": a[0].shape[0], "Q": a[0].shape[1],
                                   "N": a[1].shape[1], "k": a[5]}
                                  for a in ball_calls],
            "fps_single_launches": fcounts, "plain_path_checks": checks,
            "banded_calls": {"3DMatch": rows, "KITTI": krows},
            "banded_quality": quality, "exact_search_reference": reference,
            "kernels": kernels, "issue_floor": derived, "phase_s": phases,
            "dp_register": dp_register, "dp_train": dp_train,
            "dp_eval": dp_eval, "synthetic_eval": synthetic,
            "calibrate": calibration,
            "pose_gt": {"3DMatch": [T.tolist() for T in poses_gt],
                        "KITTI": [T.tolist() for T in kposes_gt]}}


if __name__ == "__main__":
    sys.exit(main())
