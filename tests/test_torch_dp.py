"""Data parallelism over pairs on the CPU: the port's ``make_dp_train_step``,
``make_dp_register`` and ``run_eval`` in its DP rounds, at world 2, each
rank a fresh interpreter started by ``utils/dist.launch`` (gloo, one thread
a rank), held to the port's own one-process step or registration and to
the JAX package's ``make_dp_train_step``, ``make_dp_register`` and
``run_eval(use_dp=True)`` on a 2-device CPU mesh.

The ranks import neither this module nor JAX: their programs live in
``buffer_tpu_torch/utils/dp_jobs.py``.  JAX is held to the TPU kernels'
semantics as in ``test_torch_train.py`` and ``test_torch_registration.py``
(interpret mode, the TPU dispatch); inside its vmap over pairs each pair's
pyramid is the one JAX builds for that pair alone (built once per module,
picked by the pair's points)."""

import functools
import os
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.sharding import Mesh

import buffer_tpu.config as jconfig
import buffer_tpu.kernels.geom_pallas as gp
import buffer_tpu.pipeline.train_forward as jtf
from buffer_tpu.data import preprocess as jpre
from buffer_tpu.data import threedmatch as jtdm
from buffer_tpu.eval import harness as jharness
from buffer_tpu.models import patch_embedder as jpe
from buffer_tpu.models.composite import BufferModel as JModel
from buffer_tpu.pipeline import pyramid as jpyr
from buffer_tpu.train import trainer as jtr

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.data.preprocess import prepare_pair
from buffer_tpu_torch.data.synthetic import surface_pair
from buffer_tpu_torch.eval import harness, metrics
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.pipeline.registration import make_draws, register_pair
from buffer_tpu_torch.pipeline.train_forward import make_train_draws, stage_loss
from buffer_tpu_torch.scripts.test import make_dataset
from buffer_tpu_torch.train.trainer import (TrainBatch, make_optimizer,
                                            mean_train_step)
from buffer_tpu_torch.utils import dist as tdist

import fixtures_gen
from test_torch_registration import (_fused_kernel_semantics, _jax_draws,
                                     _tpu_dispatch)
from test_torch_train import (hold_jax_to_tpu, jax_state,
                              jax_train_draws, port_model, surface_pair_np)

torch.set_num_threads(1)

STAGES = ("Ref", "Desc", "Keypt", "Inlier")
# JAX's DP step per stage is a vmapped compile in interpret mode: Ref and
# Desc, the stages with the loosest allowances, are held to it; all four
# to the port's one-process step
JAX_STAGES = ("Ref", "Desc")
LIMIT = 240.0          # seconds a launch may take before its ranks are killed


def launch(target, payload, world=2, backend="gloo", timeout=LIMIT):
    return tdist.launch(target, payload, world, backend=backend, device="cpu",
                        timeout=timeout, threads=1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    """Two distinct pairs (wavy surfaces of seeds 0 and 1 under a known
    motion) through both packages' ``prepare_pair``, JAX's initial
    variables and the port's state dict of them."""
    jcfg, tcfg = jconfig.tiny_cfg(), tconfig.tiny_cfg()
    pairs = []
    for seed in (0, 1):
        raw, tgt, T = surface_pair_np(900, seed)
        ji = jpre.prepare_pair(jcfg, raw.copy(), tgt.copy(),
                               rs=np.random.RandomState(3 + seed),
                               already_downsampled=True)
        ti = prepare_pair(tcfg, raw.copy(), tgt.copy(),
                          rs=np.random.RandomState(3 + seed),
                          already_downsampled=True, device="cpu")
        pairs.append((ji, ti, T))
    jm = JModel(jcfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    state = port_model(tcfg, variables).state_dict()
    return jcfg, tcfg, pairs, jm, variables, state


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

TRAIN_KEYS = jax.random.split(jax.random.PRNGKey(5), 2)   # one per pair


@pytest.fixture(scope="module")
def dp_train(setup):
    """One launch at world 2: each stage from the initial state, one DP
    step on pair r at rank r with JAX's draws of key r."""
    jcfg, tcfg, pairs, _, _, state = setup
    draws = [jax_train_draws(k, jcfg) for k in TRAIN_KEYS]
    batches = [TrainBatch(ti, _t(T)) for _, ti, T in pairs]
    out = launch("buffer_tpu_torch.utils.dp_jobs:train_job",
                 {"cfg": tcfg, "state": state, "stages": list(STAGES),
                  "batches": [batches], "draws": {s: [draws] for s in STAGES},
                  "device": "cpu"})
    return out, batches, draws


@pytest.fixture(scope="module")
def jax_pyramids(setup):
    """JAX's pyramid of each pair, under the TPU dispatch."""
    jcfg, _, pairs, *_ = setup
    mp = pytest.MonkeyPatch()
    hold_jax_to_tpu(mp)
    try:
        build = jax.jit(lambda *a: jpyr.build_pyramid_and_normals(
            jcfg, a[0], a[1], levels=a[2:]))
        pyrs = [jax.tree_util.tree_map(np.asarray, build(
            ji.sds, ji.sds_mask, ji.lvl1, ji.lvl1_mask, ji.lvl2, ji.lvl2_mask))
            for ji, _, _ in pairs]
    finally:
        mp.undo()
    return pyrs


def _pick(pairs, field, per_pair):
    """A stand-in for a function of one pair that returns ``per_pair[r]``
    for the pair whose ``sds`` (``field`` 0: both clouds, 1: the source
    cloud) it is given first; traced inside JAX's vmap over pairs."""
    first = jnp.asarray(pairs[0][0].sds if field == 0 else pairs[0][0].sds[0])

    def fn(_, pts, *rest, **kw):
        is0 = jnp.all(pts == first)
        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(is0, jnp.asarray(a), jnp.asarray(b)),
            *per_pair)
    return fn


def hold_jax_dp(monkeypatch, pairs, pyrs):
    """JAX's DP step held to the TPU kernels' semantics and to each pair's
    own one-device numerics: every pair's pyramid, and the ground-truth
    warp of its positive-pair sampler, as JAX computes them for that pair
    alone.  Partitioned over two devices, XLA rounds the warp one ulp
    apart, which flips sampled matches at rounding distance (ROADMAP.md
    section 3) and moves JAX's own loss by ~0.4% against its one-device
    mesh."""
    hold_jax_to_tpu(monkeypatch)
    monkeypatch.setattr(jtf, "build_pyramid_and_normals",
                        lambda cfg, sds, *a, **k: _pick(pairs, 0, pyrs)(
                            cfg, sds))
    warp = jax.jit(jtf.se3.transform)
    warps = [np.asarray(warp(ji.sds[0], jnp.asarray(T))) for ji, _, T in pairs]
    monkeypatch.setattr(jtf, "se3", types.SimpleNamespace(
        transform=lambda pts, pose: _pick(pairs, 1, warps)(None, pts)))


@pytest.mark.parametrize("stage", STAGES)
def test_dp_train_step(setup, dp_train, jax_pyramids, monkeypatch, stage):
    """The DP step of ``stage`` at world 2: parameters, running statistics,
    loss and stats bit-equal across ranks; the port's one-process step on
    the mean gradient within 1e-6; the running statistics the mean of the
    two one-pair updates (1e-6); frozen stages untouched.  For JAX_STAGES,
    JAX's ``make_dp_train_step`` on a 2-device mesh within the DP training
    allowances of ROADMAP.md section 3: the loss to 1e-3, 95% of the
    parameters within 0.1 lr and all within 2 lr, running statistics to
    1e-3 (over these two pairs and keys the Ref loss of a pair differs by
    up to 3.5e-4 and 2.5% of Desc's parameters by more than 0.1 lr after
    Adam's first step, from the fp32 conditioning that section names)."""
    jcfg, tcfg, pairs, jm, variables, state = setup
    out, batches, draws = dp_train
    got = [o["stages"][stage]["steps"][0] for o in out]
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k
    assert torch.equal(got[0]["loss"], got[1]["loss"])
    assert got[0]["stats"].keys() == got[1]["stats"].keys()
    assert all(torch.equal(v, got[1]["stats"][k])
               for k, v in got[0]["stats"].items())
    assert float(got[0]["stats"]["grad_finite"]) == 1.0
    assert got[0]["others_changed"] == [] == got[1]["others_changed"]
    dp = got[0]["state"]

    # the port's one-process step on the mean gradient
    model = BufferModel(tcfg)
    model.load_state_dict(state)
    opt, _ = make_optimizer(tcfg, model, stage)
    loss, stats = mean_train_step(model, opt, stage, batches, draws,
                                  device="cpu")
    ref = model.state_dict()
    moved = 0
    for k, v in dp.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=1e-6, msg=k)
        moved += not torch.equal(v, state[k])
    assert moved
    torch.testing.assert_close(got[0]["loss"], loss, rtol=0, atol=1e-6)

    # the running statistics: the mean of two one-pair updates
    upd = []
    for batch, dr in zip(batches, draws):
        m = BufferModel(tcfg)
        m.load_state_dict(state)
        with torch.no_grad():
            stage_loss(m, stage, batch.inputs, batch.relt_pose, dr,
                       device="cpu")
        upd.append(m.state_dict())
    running = [k for k in dp if "running" in k]
    assert running
    for k in running:
        torch.testing.assert_close(dp[k], (upd[0][k] + upd[1][k]) / 2,
                                   rtol=0, atol=1e-6, msg=k)

    if stage not in JAX_STAGES:
        return
    hold_jax_dp(monkeypatch, pairs, jax_pyramids)
    tx, _ = jtr.make_optimizer(jcfg, stage)
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    step = jtr.make_dp_train_step(jm, tx, stage, mesh)
    stack = lambda *xs: jnp.stack([jnp.asarray(x) for x in xs])
    batch = jtr.TrainBatch(
        inputs=jax.tree_util.tree_map(stack, pairs[0][0], pairs[1][0]),
        relt_pose=stack(pairs[0][2], pairs[1][2]))
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    new_v, _, loss_j, stats_j = step(v, tx.init(v[stage]["params"]), batch,
                                     TRAIN_KEYS)
    np.testing.assert_allclose(float(got[0]["loss"]), float(loss_j),
                               rtol=1e-3, atol=1e-5)
    assert set(got[0]["stats"]) == set(stats_j)
    lr = jcfg.optim.lr[stage]
    want = jax_state(jax.tree_util.tree_map(np.asarray, new_v), stage)
    diff = np.concatenate([np.abs(dp[k].numpy() - w).ravel()
                           for k, w in want.items() if "running" not in k])
    assert diff.max() <= 2 * lr + 1e-6
    assert (diff <= 0.1 * lr).mean() >= 0.95
    for k, w in want.items():
        if "running" in k:
            np.testing.assert_allclose(dp[k].numpy(), w, rtol=1e-3,
                                       atol=1e-4, err_msg=k)


def test_dp_train_step_skips_coherently(setup):
    """A step whose rank 1 has a NaN pose: the reduced gradients are not
    finite, so on both ranks ``grad_finite`` is 0 and neither the
    parameters nor Adam's state move from the step before (a finite one)."""
    _, tcfg, pairs, _, _, state = setup
    gen = torch.Generator().manual_seed(4)
    batches = [TrainBatch(ti, _t(T)) for _, ti, T in pairs]
    bad = TrainBatch(batches[1].inputs, torch.full((4, 4), float("nan")))
    draws = [[make_train_draws(tcfg, gen, "cpu") for _ in range(2)]
             for _ in range(2)]
    out = launch("buffer_tpu_torch.utils.dp_jobs:train_job",
                 {"cfg": tcfg, "state": state, "stages": ["Ref"],
                  "batches": [batches, [batches[0], bad]],
                  "draws": {"Ref": draws}, "device": "cpu", "adam": True})
    for o in out:
        first, second = o["stages"]["Ref"]["steps"]
        assert float(first["stats"]["grad_finite"]) == 1.0
        assert float(second["stats"]["grad_finite"]) == 0.0
        for k, v in first["state"].items():
            if "running" not in k and "num_batches" not in k:
                assert torch.equal(v, second["state"][k]), k
        for a, b in zip(first["adam"], second["adam"]):
            assert a.keys() == b.keys() and a
            assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(v, state[k])
               for k, v in out[0]["stages"]["Ref"]["steps"][0]["state"].items())


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

def test_dp_register_matches_jax_and_one_process(setup, monkeypatch):
    """``make_dp_register`` at world 2 on the two pairs with JAX's draws of
    its per-pair keys: on both ranks the gathered poses and ``num_mutual``
    equal the port's one-process ``register_pair`` bit for bit, and JAX's
    ``make_dp_register`` on a 2-device mesh with the same keys at the
    registration tolerances (pose 1e-3, equal mutual counts)."""
    jcfg, tcfg, pairs, jm, variables, state = setup
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    draws = [_jax_draws(k, jcfg) for k in keys]
    t_inputs = [ti for _, ti, _ in pairs]
    out = launch("buffer_tpu_torch.utils.dp_jobs:register_job",
                 {"cfg": tcfg, "state": state, "pairs": t_inputs,
                  "draws": draws, "device": "cpu"})
    assert torch.equal(out[0]["pose"], out[1]["pose"])
    assert torch.equal(out[0]["num_mutual"], out[1]["num_mutual"])
    model = BufferModel(tcfg)
    model.load_state_dict(state)
    for i, (inp, dr) in enumerate(zip(t_inputs, draws)):
        res = register_pair(model.eval(), inp, dr, device="cpu")
        assert torch.equal(res.pose, out[0]["pose"][i])
        assert int(res.num_mutual) == int(out[0]["num_mutual"][i])

    monkeypatch.setattr(gp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jpe, "fused_point_features", _fused_kernel_semantics)
    _tpu_dispatch(monkeypatch)
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    stack = lambda *xs: jnp.stack([jnp.asarray(x) for x in xs])
    res_j = jharness.make_dp_register(jm, mesh)(
        jax.tree_util.tree_map(jnp.asarray, variables),
        jax.tree_util.tree_map(stack, pairs[0][0], pairs[1][0]), keys)
    np.testing.assert_allclose(out[0]["pose"].numpy(), np.asarray(res_j.pose),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(out[0]["num_mutual"].numpy(),
                                  np.asarray(res_j.num_mutual))
    assert (out[0]["num_mutual"] > 0).all()


# ---------------------------------------------------------------------------
# run_eval and the test entry point
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_dp") / "3dm")
    os.makedirs(root)
    return root, fixtures_gen.make_threedmatch_tree(root)


def _with_root(cfg, root):
    return cfg.replace(data=cfg.data.__class__(**{**cfg.data.__dict__,
                                                  "root": root}))


def _est(log_dir, scene):
    with open(os.path.join(log_dir, scene, "est.log")) as f:
        return f.read()


def _same_summary(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k in ("model_time", "data_time"):
            continue
        assert a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])), k


def test_run_eval_dp_matches_world_1_and_jax(setup, tree, monkeypatch,
                                            tmp_path):
    """``run_eval`` over the 3DMatch fixture tree (3 pairs: the second round
    padded) at world 2, with JAX's draws rebuilt from its DP rounds' key
    splits (``harness.py:145-146``): every rank's summary and the est.log
    equal ``run_eval`` at world 1 with the same draws; poses, recall and
    registration recall agree with JAX's ``run_eval(use_dp=True)`` on a
    2-device mesh."""
    jcfg0, _, _, jm, variables, state = setup
    root, scene = tree
    jcfg = _with_root(jconfig.shrink_static(jconfig.make_cfg("3DMatch")), root)
    jcfg = jcfg.replace(static=jcfg.static.__class__(
        **{**jcfg.static.__dict__, "pair_unroll": 1}))
    tcfg = _with_root(tconfig.shrink_static(tconfig.make_cfg("3DMatch")), root)
    key, subs = jax.random.PRNGKey(0), []
    for _ in range(2):                     # rounds of D = 2 pairs
        key, sub = jax.random.split(key)
        subs.extend(jax.random.split(sub, 2))
    draws = [_jax_draws(k, jcfg) for k in subs[:3]]

    logs = {w: str(tmp_path / f"world{w}") for w in (1, 2)}
    got = launch("buffer_tpu_torch.utils.dp_jobs:eval_job",
                 {"cfg": tcfg, "state": state, "log_dir": logs[2],
                  "draws": draws, "device": "cpu"})
    model = BufferModel(tcfg)
    model.load_state_dict(state)
    one = harness.run_eval(tcfg, model.eval(), make_dataset(tcfg),
                           log_dir=logs[1], device="cpu",
                           draws_fn=draws.__getitem__)
    assert one["pairs"] == 3
    for g in got:
        _same_summary(g, got[0])
        assert g["model_time"] == got[0]["model_time"]
    _same_summary(got[0], one)
    assert _est(logs[2], scene) == _est(logs[1], scene)

    monkeypatch.setattr(gp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jpe, "fused_point_features", _fused_kernel_semantics)
    _tpu_dispatch(monkeypatch)
    two = jax.devices()[:2]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: two)
    jlog = str(tmp_path / "jax")
    want = jharness.run_eval(jcfg, variables, jtdm.ThreeDMatchDataset("test", jcfg),
                             log_dir=jlog, seed=0, use_dp=True)
    assert want["pairs"] == got[0]["pairs"] == 3
    assert got[0]["recall"] == want["recall"]
    assert got[0]["registration_recall"] == want["registration_recall"]
    (pairs, traj), (pairs_j, traj_j) = (
        metrics.read_trajectory(os.path.join(d, scene, "est.log"))
        for d in (logs[2], jlog))
    np.testing.assert_array_equal(pairs, pairs_j)
    np.testing.assert_allclose(np.linalg.inv(traj), np.linalg.inv(traj_j),
                               rtol=1e-3, atol=1e-3)


def test_test_entry_point_under_torchrun(tree, tmp_path):
    """The test entry point started as 2 ranks with the ``torchrun``
    variables (gloo on the CPU) takes the DP rounds: every rank returns the
    one-process run's recall, TE, RE and pairs, and rank 0's est.log is
    the one-process run's (the same generator draws a pair)."""
    root, scene = tree
    weights = str(tmp_path / "snap")
    sd = BufferModel(tconfig.tiny_cfg(), seed=5).state_dict()
    for s in STAGES:
        os.makedirs(os.path.join(weights, s))
        torch.save(sd, os.path.join(weights, s, "best.pth"))
    argv = lambda log: ["--config", "3DMatch", "--tiny", "--device", "cpu",
                        "--data-root", root, "--torch-weights", weights,
                        "--log-dir", log]
    got = launch("buffer_tpu_torch.scripts.test:main", argv(str(tmp_path / "dp")),
                 backend=None)
    from buffer_tpu_torch.scripts import test as entry
    one = entry.main(argv(str(tmp_path / "one")))
    for g in got:
        _same_summary(g, one)
    assert got[0]["pairs"] == 3
    assert _est(str(tmp_path / "dp"), scene) == _est(str(tmp_path / "one"), scene)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_raises_when_a_rank_fails():
    """Rank 1 raises (its pair has no draws) while rank 0 waits in the
    all-gather: the launcher kills rank 0 and raises, well within its
    limit."""
    cfg = tconfig.tiny_cfg()
    pair, _ = surface_pair(cfg, 0, "cpu")
    draws = [make_draws(cfg, torch.Generator().manual_seed(0), "cpu")]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited"):
        launch("buffer_tpu_torch.utils.dp_jobs:register_job",
               {"cfg": cfg, "state": BufferModel(cfg).state_dict(),
                "pairs": [pair, pair], "draws": draws, "device": "cpu"},
               timeout=120)
    assert time.monotonic() - t0 < 60


def test_launcher_time_limit():
    """Ranks past the time limit are killed and the launcher raises."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        launch("time:sleep", 60, backend=None, timeout=3)
    assert time.monotonic() - t0 < 30
