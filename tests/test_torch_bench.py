"""The port's benchmark entry point (``buffer_tpu_torch/bench.py``) on the
CPU: its pair against the repository's ``bench.synthetic_pair`` array for
array (seeds 0-2; also the measurement scripts' pair), its rotation
against the JAX draw, its static-plan overrides against ``bench.py``'s,
the differenced timing on a fake clock, the JSON line of
``main`` at the tiny plan with each pair of its last call bit-equal to
``register_pair`` on the same pair and draws, ``--batch`` and ``--unroll``
with bench.py's defaults, the measured call's pose against JAX's
``register_pair`` on ``bench.py``'s tiny pair (the tolerances of
``test_torch_registration.py``), and no fallback to the CPU."""

import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

import bench as jbench
import buffer_tpu.config as jconfig
import buffer_tpu.kernels.geom_pallas as gp
from buffer_tpu.core import se3 as jse3
from buffer_tpu.models import patch_embedder as jpe
from buffer_tpu.models.composite import BufferModel as JModel
from buffer_tpu.pipeline.registration import register_pair as j_register_pair

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch import bench
from buffer_tpu_torch.compat.from_jax import variables_to_state_dict
from buffer_tpu_torch.data.synthetic import (BENCH_ROTATION, bench_pair,
                                             lidar_pair)
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.pipeline import registration

from test_torch_registration import (_fused_kernel_semantics, _jax_draws,
                                     _tpu_dispatch)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
EXTRA_KEYS = {"ms_per_pair", "compile_s", "sanity_rte_m", "sanity_rre_deg",
              "mutual_matches", "platform", "size", "config", "pair_batch",
              "pair_unroll", "build_s", "device_ms_per_pair", "boost_pairs",
              "weights", "card"}


@pytest.mark.parametrize("plan,seed", [("tiny", 0), ("tiny", 1), ("tiny", 2),
                                       ("3DMatch", 0)])
def test_bench_pair_is_bench_py_pair(plan, seed):
    """``bench_pair(cfg, seed=s)`` is ``bench.synthetic_pair(cfg, seed=s)``
    array for array and T exactly: seeds 0-2 at the tiny plan, seed 0 at
    the full 3DMatch plan."""
    jcfg = jconfig.tiny_cfg() if plan == "tiny" else jconfig.make_cfg(plan)
    tcfg = tconfig.tiny_cfg() if plan == "tiny" else tconfig.make_cfg(plan)
    want, T_want = jbench.synthetic_pair(jcfg, seed=seed)
    got, T_got = bench_pair(tcfg, device="cpu", seed=seed)
    assert T_got.dtype == np.float32
    np.testing.assert_array_equal(T_got, np.asarray(T_want))
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == torch.from_numpy(np.asarray(w)).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    n = min(tcfg.static.raw_points, 60000)
    assert int(got.raw_mask.sum()) > 0 and got.raw.shape[1] >= n // 2


def test_profiled_pair_is_the_bench_pair():
    """The measurement scripts' 3DMatch pair (``profile_stages.
    profile_pair``) is ``bench_pair`` seed 0, with draws from a generator
    seeded 0; KITTI's is ``lidar_pair`` seed 13."""
    from buffer_tpu_torch.pipeline.registration import make_draws
    from buffer_tpu_torch.scripts.profile_stages import profile_pair
    same = lambda g, w: (g is None) == (w is None) and (
        g is None or torch.equal(g, w))
    for make in (tconfig.tiny_cfg,
                 lambda: tconfig.shrink_static(tconfig.make_cfg("KITTI"))):
        cfg = make()
        inputs, T, draws = profile_pair(cfg, CPU)
        want, T_want = (lidar_pair(cfg, 13, CPU) if cfg.data.dataset == "KITTI"
                        else bench_pair(cfg, CPU))
        np.testing.assert_array_equal(T, T_want)
        for name, g, w in zip(inputs._fields, inputs, want):
            assert same(g, w), name
        for name, g, w in zip(draws._fields, draws, make_draws(
                cfg, torch.Generator().manual_seed(0), CPU)):
            assert same(g, w), name


def test_bench_rotation_is_the_jax_draw():
    """BENCH_ROTATION holds the float32 bits of bench.py:57's draw."""
    want = np.asarray(jse3.random_rotation(jax.random.PRNGKey(11), 3))
    assert want.dtype == BENCH_ROTATION.dtype == np.float32
    np.testing.assert_array_equal(BENCH_ROTATION.view(np.uint32),
                                  want.view(np.uint32))


class _Cfg(Exception):
    """Carries the config that bench.py's main builds its model from."""


def _bench_py_cfg(monkeypatch, argv):
    """The config bench.py's ``main`` makes for ``argv``: its model
    constructor raises with the config before anything runs."""
    import buffer_tpu.models.composite as composite

    def capture(cfg):
        raise _Cfg(cfg)

    monkeypatch.setattr(composite, "BufferModel", capture)
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    with pytest.raises(_Cfg) as e:
        jbench.main()
    return e.value.args[0]


@pytest.mark.parametrize("argv", [
    [], ["--caps", "24"], ["--normal-knn", "12"], ["--l1", "8192"],
    ["--l2", "2048"], ["--size", "small", "--caps", "8", "--normal-knn", "6",
                       "--l1", "200", "--l2", "100"],
    ["--config", "KITTI", "--caps", "40", "--l2", "4096"]])
def test_static_overrides_are_bench_py_overrides(monkeypatch, argv):
    """The four static-plan flags give the StaticConfig that bench.py:97-111
    gives for the same flags, field for field."""
    want = _bench_py_cfg(monkeypatch, argv).static
    got = bench.bench_cfg(bench.parser().parse_args(argv)).static
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


class _FakeClock:
    """A clock that a run advances by its fixed cost, its calls and the
    noise of its turn."""

    def __init__(self, fixed, per_call, noise):
        self.t, self.fixed, self.per_call = 0.0, fixed, per_call
        self.noise, self.turn, self.runs = list(noise), 0, []

    def __call__(self):
        return self.t

    def run(self, n):
        self.runs.append(n)
        self.t += self.fixed + n * self.per_call + self.noise[self.turn]
        self.turn += 1


@pytest.mark.parametrize("noise", [[0.0] * 6,
                                   [0.5, 0.0, 0.25, 0.125, 0.0, 0.75]])
def test_differenced_ms_fake_clock(noise):
    """reps runs at n_lo, then at n_hi; the least of each, differenced:
    the fixed cost and the noise of every run but the least cancel."""
    clock = _FakeClock(fixed=3.0, per_call=0.0625, noise=noise)
    ms = bench.differenced_ms(clock.run, 2, 12, 3, clock=clock)
    assert clock.runs == [2, 2, 2, 12, 12, 12]
    assert ms == pytest.approx(1e3 * (10 * 0.0625 + min(noise[3:])
                                      - min(noise[:3])) / 10, abs=1e-9)
    if not any(noise):
        assert ms == 62.5


def _recorded(monkeypatch):
    """Every call of every program ``make_unrolled_register_fn`` makes, in
    call order: (model, inputs list, draws list, stacked results)."""
    calls = []
    make = registration.make_unrolled_register_fn

    def recording(model, unroll, device=None, **kw):
        fn = make(model, unroll, device=device, **kw)

        def recorded(inputs_list, draws_list):
            out = fn(inputs_list, draws_list)
            calls.append((model, inputs_list, draws_list, out))
            return out
        return recorded

    monkeypatch.setattr(registration, "make_unrolled_register_fn", recording)
    return calls


def _line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == LINE_KEYS and EXTRA_KEYS <= set(line["extra"])
    return line


def _last_call_held(calls, cfg, config, PU, n_calls, ex):
    """The last call's P x U pairs: the bench's pair in every slot, the last
    P x U of the seeded draws, each result bit-equal to ``register_pair``;
    the line's sanity and mutual count are its first pair's."""
    gen = torch.Generator().manual_seed(0)
    draws = [registration.make_draws(cfg, gen, "cpu")
             for _ in range(n_calls * PU)]
    inputs, T = (lidar_pair(cfg, 13, "cpu") if config == "KITTI"
                 else bench_pair(cfg, "cpu"))
    model, inputs_list, draws_list, got = calls[-1]
    assert len(inputs_list) == len(draws_list) == PU
    assert got.pose.shape == (PU, 4, 4)
    ref = BufferModel(cfg, seed=0).eval()
    for u, (inp, dr, d_want) in enumerate(zip(inputs_list, draws_list,
                                              draws[-PU:])):
        for a, b in zip((*inp, *dr), (*inputs, *d_want)):
            assert (a is None and b is None) or torch.equal(a, b)
        want = registration.register_pair(ref, inputs, d_want, device="cpu")
        for name, a, b in zip(want._fields, (t[u] for t in got), want):
            assert torch.equal(a, b), (u, name)
    first = registration.register_pair(ref, inputs, draws[-PU], device="cpu")
    assert int(first.num_mutual) == ex["mutual_matches"]
    rte, rre = bench.sanity(first.pose.numpy(), T)
    assert (ex["sanity_rte_m"], ex["sanity_rre_deg"]) == (round(rte, 4),
                                                          round(rre, 3))


@pytest.mark.parametrize("config", ["3DMatch", "KITTI"])
def test_main_line_and_last_pose(monkeypatch, capsys, config):
    """``main`` at the tiny plan on the CPU prints one JSON line with
    bench.py's keys and the port's; its default pairs a call are bench.py's
    (the tiny plan's ``pair_unroll = 3``, batch 1, whatever the config);
    each pair of its last timed call is bit-equal to ``register_pair`` on
    the bench's pair with that pair's draws and the seeded weights."""
    calls = _recorded(monkeypatch)
    assert bench.main(["--size", "small", "--device", "cpu", "--iters", "2",
                       "--config", config]) == 0
    line = _line(capsys)
    ex = line["extra"]
    assert line["metric"] == ("kitti_pairs_per_sec_single_chip"
                              if config == "KITTI"
                              else "3dmatch_pairs_per_sec_single_chip")
    assert line["unit"] == "pairs/s" and line["value"] > 0
    # value and vs_baseline to 3 decimals, ms_per_pair to 2, as bench.py
    value = line["value"]
    assert abs(line["vs_baseline"] - value / 4.0) <= 0.0005 + 0.000125 + 1e-9
    assert abs(1e3 / value - ex["ms_per_pair"]) <= (
        0.005 + 1e3 * 0.0005 / (value * (value - 0.0005)) + 1e-9)
    assert (ex["platform"], ex["size"], ex["config"], ex["weights"]) == (
        "cpu", "small", config, "random")
    assert (ex["pair_batch"], ex["pair_unroll"]) == (1, 3)
    for k in ("build_s", "device_ms_per_pair", "card", "capture_s",
              "launches_per_pair"):
        assert ex[k] is None, k
    # the first call, 3 runs of 2 and 3 runs of 4 calls, 3 pairs a call
    assert ex["calls"] == len(calls) == 1 + 3 * 2 + 3 * 4
    assert ex["timed_pairs"] == 4 * 3 and ex["boost_pairs"] == 0
    _last_call_held(calls, tconfig.tiny_cfg(), config, 3, 4, ex)


@pytest.mark.parametrize("argv,P,U", [
    ([], 1, 3), (["--config", "KITTI"], 1, 1), (["--size", "small"], 1, 3),
    (["--size", "small", "--config", "KITTI"], 1, 3),
    (["--unroll", "2"], 1, 2), (["--config", "KITTI", "--unroll", "2"], 1, 2),
    (["--batch", "2"], 2, 1), (["--batch", "2", "--unroll", "3"], 2, 3)])
def test_pairs_per_call_are_bench_py_defaults(argv, P, U):
    """(P, U) of bench.py:141-143: P the flag or ``static.pair_batch``, U the
    flag or, at P = 1, ``static.pair_unroll`` (3DMatch and the tiny plan 3,
    KITTI 1), else 1; the presets' fields equal the JAX package's."""
    args = bench.parser().parse_args(argv)
    cfg = bench.bench_cfg(args)
    jcfg = (jconfig.make_cfg(args.config) if args.size == "full"
            else jconfig.tiny_cfg())
    assert (cfg.static.pair_batch, cfg.static.pair_unroll) == (
        jcfg.static.pair_batch, jcfg.static.pair_unroll)
    assert bench.pairs_per_call(cfg, args) == (P, U)


@pytest.mark.parametrize("flags,P,U", [(["--unroll", "2"], 1, 2),
                                       (["--batch", "2"], 2, 1),
                                       (["--unroll", "1", "--boost"], 1, 1),
                                       (["--unroll", "2", "--boost"], 1, 2)])
def test_main_batch_and_unroll_flags(monkeypatch, capsys, flags, P, U):
    """``--unroll`` and ``--batch`` at the tiny plan on the CPU: P x U pairs a
    call through one unrolled program, each pair with its own draws; the
    line reports the P and U that ran, ``ms_per_pair`` a call's differenced
    time over P x U (a fixed 600 ms a call here), ``timed_pairs`` and
    ``boost_pairs`` in pairs (``--boost``, a test flag: every pair on the
    low-match tail), and the last call's pairs each equal
    ``register_pair``."""
    boost = "--boost" in flags
    flags = [f for f in flags if f != "--boost"]
    cfg = tconfig.tiny_cfg()
    if boost:
        cfg = cfg.replace(static=dataclasses.replace(
            cfg.static, low_match_boost=True, low_match_th=10 ** 6))
        monkeypatch.setattr(bench, "bench_cfg", lambda args: cfg)
    monkeypatch.setattr(bench, "REPS", 1)
    monkeypatch.setattr(bench, "differenced_ms",
                        lambda run, n_lo, n_hi, reps: (run(n_lo), run(n_hi),
                                                       600.0)[-1])
    calls = _recorded(monkeypatch)
    assert bench.main(["--size", "small", "--device", "cpu", "--iters", "1",
                       *flags]) == 0
    ex = _line(capsys)["extra"]
    assert (ex["pair_batch"], ex["pair_unroll"]) == (P, U)
    assert ex["ms_per_pair"] == round(600.0 / (P * U), 2)
    # the first call, a run of 2 and a run of 3 calls
    assert ex["calls"] == len(calls) == 1 + 2 + 3
    assert ex["timed_pairs"] == 3 * P * U
    assert ex["boost_pairs"] == (3 * P * U if boost else 0)
    _last_call_held(calls, cfg, "3DMatch", P * U, 3, ex)


def test_measured_pose_matches_jax(monkeypatch):
    """The bench's measured call on ``bench_pair`` at the tiny plan, with
    JAX's initial weights and JAX's draws of one key, against JAX's
    ``register_pair`` on ``bench.synthetic_pair`` (JAX held to its TPU
    kernels as in ``test_torch_registration.py``, with its tolerances):
    mutual and inlier counts equal, pose within 1e-3.  Random weights find
    no RANSAC inliers on this pair's rotation, so the pose is the identity
    in both; the pair's intermediates up to the voted hypothesis are held
    to JAX's too."""
    monkeypatch.setattr(gp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jpe, "fused_point_features", _fused_kernel_semantics)
    _tpu_dispatch(monkeypatch)
    jcfg, tcfg = jconfig.tiny_cfg(), tconfig.tiny_cfg()
    j_inputs, _ = jbench.synthetic_pair(jcfg)
    t_inputs, _ = bench_pair(tcfg, "cpu")
    jm = JModel(jcfg)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0))
    model = BufferModel(tcfg)
    model.load_state_dict({k: torch.tensor(v) for k, v in variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)).items()})
    model.eval()
    key = jax.random.PRNGKey(0)
    draws = _jax_draws(key, jcfg)
    res_j, inter_j = jax.jit(lambda v, i, k: j_register_pair(
        jm, v, i, k, return_intermediates=True))(variables, j_inputs, key)
    res = bench.measure(tcfg, model, t_inputs, [draws] * 3, CPU)["results"][-1]
    assert int(res.num_mutual) == int(res_j.num_mutual) > 0
    assert int(res.num_inliers) == int(res_j.num_inliers)
    np.testing.assert_allclose(res.pose.numpy(), np.asarray(res_j.pose),
                               rtol=1e-3, atol=1e-3)

    _, inter = registration.register_pair(model, t_inputs, draws, device="cpu",
                                          return_intermediates=True)
    np.testing.assert_array_equal(inter["kidx"].numpy(), np.asarray(inter_j["kidx"]))
    np.testing.assert_array_equal(inter["matches"].tgt_idx.numpy(),
                                  np.asarray(inter_j["matches"].tgt_idx))
    np.testing.assert_allclose(inter["azi_ind"].numpy(),
                               np.asarray(inter_j["azi_ind"]), rtol=1e-3, atol=1e-3)
    best = int(inter["best_hyp"])
    assert best == int(inter_j["best_hyp"])
    for name in ("R_h", "t_h"):
        np.testing.assert_allclose(inter[name][best].numpy(),
                                   np.asarray(inter_j[name])[best],
                                   rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(inter["vote_inliers"].numpy(),
                                  np.asarray(inter_j["vote_inliers"]))


def test_main_without_a_card_raises(capsys):
    """By default the bench runs on the card; without one it raises and
    prints nothing, with no fallback to the CPU."""
    assert not torch.cuda.is_available()
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main(argv)
    assert capsys.readouterr().out == ""


def test_command_line_prints_one_json_line_without_jax():
    """``python -m buffer_tpu_torch.bench --size small --device cpu --iters
    2`` with JAX, the JAX package and bench.py made unimportable: one line
    on stdout, a JSON object with bench.py's keys."""
    code = ("import runpy, sys\n"
            "sys.modules.update(jax=None, buffer_tpu=None, bench=None)\n"
            "sys.argv = ['bench', '--size', 'small', '--device', 'cpu', "
            "'--iters', '2']\n"
            "runpy.run_module('buffer_tpu_torch.bench', run_name='__main__')\n")
    # one thread, as the suite's own processes: an OpenMP team sharing
    # the cores with the other workers stalls unevenly, and the
    # differenced time can come out negative
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=300,
                         env=env).stdout
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == LINE_KEYS and EXTRA_KEYS <= set(line["extra"])
    assert line["extra"]["platform"] == "cpu"
