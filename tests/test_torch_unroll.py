"""Several pairs in one program: the port's ``make_unrolled_register_fn``
against the JAX package's (its ``jax.jit`` of U ``register_pair`` traces)
and against single ``register_pair`` calls, and ``run_eval`` grouping the
pairs by the preset's ``pair_unroll`` against JAX's ``run_eval``, at the
tiny plan with equal weights and JAX's draws.

JAX is held to the TPU kernels' semantics as ``tests/test_torch_registration
.py`` holds it (Pallas in interpret mode, the TPU dispatch substituted), and
the tolerances are that file's: keypoints, their validity and the mutual
and inlier counts exactly, the pose within 1e-3.  On the CPU the unrolled
program runs ``register_pair`` once a pair, so it equals U single calls bit
for bit.  The card's side (each pair bit-equal to ``make_register_fn``,
a group with both tails, a stream and a pool a chain, one host read) is in
``tests/test_torch_cuda.py``."""

import dataclasses
import functools
import os
import time

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

import buffer_tpu.config as jconfig
import buffer_tpu.kernels.geom_pallas as gp
from buffer_tpu.data import threedmatch as jtdm
from buffer_tpu.eval import harness as jharness
from buffer_tpu.models import patch_embedder as jpe
from buffer_tpu.models.composite import BufferModel as JModel
from buffer_tpu.pipeline.registration import (
    make_unrolled_register_fn as j_make_unrolled_register_fn)

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.compat.from_jax import variables_to_state_dict
from buffer_tpu_torch.data import threedmatch
from buffer_tpu_torch.data.preprocess import prepare_pair
from buffer_tpu_torch.eval import harness, metrics
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.pipeline import registration
from buffer_tpu_torch.pipeline.registration import (
    RegistrationResult, make_draws, make_unrolled_register_fn, register_pair)
from buffer_tpu_torch.utils import logging as tlogging

import fixtures_gen
from test_torch_registration import (_fused_kernel_semantics, _inputs_both,
                                     _jax_draws, _surface, _tpu_dispatch)

torch.set_num_threads(1)


def _jax_kernels(monkeypatch):
    monkeypatch.setattr(gp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jpe, "fused_point_features", _fused_kernel_semantics)
    _tpu_dispatch(monkeypatch)


def _models(jcfg, tcfg):
    """JAX's initial weights and the port's model holding them."""
    jm = JModel(jcfg)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0))
    model = BufferModel(tcfg)
    model.load_state_dict({k: torch.tensor(v) for k, v in variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)).items()})
    return jm, variables, model.eval()


def _pair(cfg, seed, n=900):
    raw = _surface(n, seed)
    return prepare_pair(cfg, raw, raw + np.float32([0.02, -0.01, 0.015]),
                        rs=np.random.RandomState(3), already_downsampled=True,
                        device="cpu")


def _unstack(res, u):
    return type(res)(*(t[u] for t in res))


def _assert_equal(got, want):
    for name in RegistrationResult._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_unrolled_matches_jax_unrolled(monkeypatch):
    """U = 2 pairs through the port's ``make_unrolled_register_fn`` on the
    CPU and JAX's ``make_unrolled_register_fn(model, 2)`` (the one test
    that compiles JAX's unrolled program of two traces), with JAX's draws
    of each pair's key of ``split(sub, 2)``: pair by pair, keypoints and
    their validity, mutual and inlier counts exactly, the pose within
    1e-3."""
    jcfg, tcfg = jconfig.tiny_cfg(), tconfig.tiny_cfg()
    _jax_kernels(monkeypatch)
    both = []
    for seed, shift in ((0, [0.02, -0.01, 0.015]), (2, [-0.01, 0.02, 0.01])):
        raw = _surface(900, seed)
        both.append(_inputs_both(jcfg, tcfg, raw, raw + np.float32(shift)))
    jm, variables, model = _models(jcfg, tcfg)
    keys = jax.random.split(jax.random.split(jax.random.PRNGKey(7))[1], 2)
    binputs = jax.tree_util.tree_map(lambda *xs: jax.numpy.stack(xs),
                                     *[j for j, _ in both])
    res_j = j_make_unrolled_register_fn(jm, 2)(variables, binputs, keys)
    res = make_unrolled_register_fn(model, 2, device="cpu")(
        [t for _, t in both], [_jax_draws(k, jcfg) for k in keys])
    assert res.pose.shape == (2, 4, 4) and res.kpts.shape[0] == 2
    for u in range(2):
        np.testing.assert_array_equal(res.kpt_valid[u].numpy(),
                                      np.asarray(res_j.kpt_valid[u]))
        np.testing.assert_array_equal(res.kpts[u].numpy(),
                                      np.asarray(res_j.kpts[u]))
        assert int(res.num_mutual[u]) == int(res_j.num_mutual[u]) > 0
        assert int(res.num_inliers[u]) == int(res_j.num_inliers[u])
        np.testing.assert_allclose(res.pose[u].numpy(),
                                   np.asarray(res_j.pose[u]),
                                   rtol=1e-3, atol=1e-3)
    assert not torch.equal(res.kpts[0], res.kpts[1])


@pytest.mark.parametrize("unroll", [1, 2, 3])
def test_unrolled_equals_single_calls(unroll):
    """Each pair of a group is ``register_pair`` on its inputs and draws,
    exactly; the results stack along a leading axis of U."""
    cfg = tconfig.tiny_cfg()
    model = BufferModel(cfg, seed=0).eval()
    gen = torch.Generator().manual_seed(0)
    pairs = [_pair(cfg, s) for s in range(unroll)]
    draws = [make_draws(cfg, gen, "cpu") for _ in pairs]
    res = make_unrolled_register_fn(model, unroll, device="cpu")(pairs, draws)
    assert res.pose.shape == (unroll, 4, 4)
    for u, (p, d) in enumerate(zip(pairs, draws)):
        _assert_equal(_unstack(res, u), register_pair(model, p, d,
                                                      device="cpu"))


def test_unrolled_intermediates_stack_single_calls():
    """``return_intermediates=True``: every tensor of the stacked
    intermediates is the single call's at its pair's index."""
    cfg = tconfig.tiny_cfg()
    model = BufferModel(cfg, seed=0).eval()
    gen = torch.Generator().manual_seed(1)
    pairs = [_pair(cfg, 0), _pair(cfg, 4)]
    draws = [make_draws(cfg, gen, "cpu") for _ in pairs]
    res, inter = make_unrolled_register_fn(model, 2, device="cpu",
                                           return_intermediates=True)(pairs,
                                                                      draws)
    leaves = torch.utils._pytree.tree_leaves
    for u, (p, d) in enumerate(zip(pairs, draws)):
        want_res, want = register_pair(model, p, d, device="cpu",
                                       return_intermediates=True)
        _assert_equal(_unstack(res, u), want_res)
        for name in want:
            got = leaves(inter[name])
            assert len(got) == len(leaves(want[name])), name
            assert all(torch.equal(a[u], b) for a, b in
                       zip(got, leaves(want[name]))), name


def test_unrolled_group_takes_both_tails():
    """The low-match budget on, ``low_match_th`` between the two pairs'
    mutual counts: one pair of the group takes the boost tail and the
    other the base tail, each equal to its single call."""
    c = tconfig.tiny_cfg()
    base = c.replace(static=dataclasses.replace(c.static, low_match_boost=True,
                                                low_match_th=0))
    pairs = [_pair(base, 0), _pair(base, 2, n=700)]
    gen = torch.Generator().manual_seed(2)
    draws = [make_draws(base, gen, "cpu") for _ in pairs]
    model = BufferModel(base, seed=0).eval()
    counts = [int(register_pair(model, p, d, device="cpu").num_mutual)
              for p, d in zip(pairs, draws)]
    assert min(counts) < max(counts), counts
    cfg = base.replace(static=dataclasses.replace(base.static,
                                                  low_match_th=max(counts)))
    model = BufferModel(cfg, seed=0).eval()
    res = make_unrolled_register_fn(model, 2, device="cpu")(pairs, draws)
    taken = [registration.boost_taken(cfg, n) for n in res.num_mutual]
    assert sorted(taken) == [False, True]
    for u, (p, d) in enumerate(zip(pairs, draws)):
        _assert_equal(_unstack(res, u), register_pair(model, p, d,
                                                      device="cpu"))


def test_unrolled_checks_its_arguments():
    """A group of another length than ``unroll`` and an ``unroll`` under 1
    raise; without a card the default device raises too."""
    cfg = tconfig.tiny_cfg()
    model = BufferModel(cfg, seed=0).eval()
    pair = _pair(cfg, 0)
    draws = make_draws(cfg, torch.Generator().manual_seed(0), "cpu")
    fn = make_unrolled_register_fn(model, 2, device="cpu")
    with pytest.raises(ValueError, match="for 2 pairs"):
        fn([pair], [draws])
    with pytest.raises(ValueError, match="at least 1"):
        make_unrolled_register_fn(model, 0, device="cpu")
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_unrolled_register_fn(model, 2)


# ---------------------------------------------------------------------------
# run_eval at the preset's pair_unroll
# ---------------------------------------------------------------------------

class _Repeated:
    """The first ``n`` items of ``dataset`` cycled: a tree's 3 pairs as 4
    (the fourth is the first again), so that at U = 3 a full group is
    followed by a padded one."""

    def __init__(self, dataset, n):
        self.dataset, self.n = dataset, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.dataset[i % len(self.dataset)]


class _FixedTimer(tlogging.Timer):
    """A timer whose every interval lasts 0.6 s."""

    def toc(self, average=True):
        self.start_time = time.time() - 0.6
        return super().toc(average)


def _with_root(cfg, root):
    return cfg.replace(data=cfg.data.__class__(**{**cfg.data.__dict__,
                                                  "root": root}))


def test_run_eval_unrolled_matches_jax(monkeypatch, tmp_path):
    """Both harnesses over the 3DMatch fixture tree's 3 pairs and the first
    again (4 pairs) at the tiny plan with the preset's ``pair_unroll = 3``
    (no override): JAX registers a group of 3, then a group of the fourth
    pair padded with itself; the port groups likewise, fed JAX's draws of
    each group's key split (``harness.py:169-170``).  Pairs, recall,
    registration recall and est.log agree (poses within 1e-3); the port's
    ``model_time`` is a group's time over 3 and its ``data_time`` a pair's;
    every pair equals ``register_pair`` on its draws."""
    root = str(tmp_path / "3dm")
    os.makedirs(root)
    scene = fixtures_gen.make_threedmatch_tree(root)
    _jax_kernels(monkeypatch)
    jcfg = _with_root(jconfig.shrink_static(jconfig.make_cfg("3DMatch")), root)
    tcfg = _with_root(tconfig.shrink_static(tconfig.make_cfg("3DMatch")), root)
    assert jcfg.static.pair_unroll == tcfg.static.pair_unroll == 3
    _, variables, model = _models(jcfg, tcfg)

    key, keys = jax.random.PRNGKey(0), []
    for _ in range(2):                                 # groups of U = 3
        key, sub = jax.random.split(key)
        keys.extend(jax.random.split(sub, 3))
    draws = [_jax_draws(k, jcfg) for k in keys]
    jlog, tlog = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jharness.run_eval(
        jcfg, variables, _Repeated(jtdm.ThreeDMatchDataset("test", jcfg), 4),
        log_dir=jlog, seed=0, use_dp=False)
    calls = []
    make = registration.make_unrolled_register_fn

    def recording(model, unroll, device=None, **kw):
        fn = make(model, unroll, device=device, **kw)

        def recorded(inputs_list, draws_list):
            out = fn(inputs_list, draws_list)
            calls.append((inputs_list, draws_list, out))
            return out
        return recorded

    monkeypatch.setattr(harness, "make_unrolled_register_fn", recording)
    monkeypatch.setattr(harness, "Timer", _FixedTimer)
    got = harness.run_eval(
        tcfg, model, _Repeated(threedmatch.ThreeDMatchDataset("test", tcfg), 4),
        log_dir=tlog, seed=0, device="cpu", draws_fn=draws.__getitem__)
    assert set(got) == set(want)
    assert got["pairs"] == want["pairs"] == 4
    assert got["recall"] == want["recall"]
    assert got["registration_recall"] == want["registration_recall"]
    (pairs, traj), (pairs_j, traj_j) = (
        metrics.read_trajectory(os.path.join(d, scene, "est.log"))
        for d in (tlog, jlog))
    np.testing.assert_array_equal(pairs, pairs_j)
    np.testing.assert_allclose(np.linalg.inv(traj), np.linalg.inv(traj_j),
                               rtol=1e-3, atol=1e-3)
    assert got["model_time"] == pytest.approx(0.2, abs=1e-3)
    assert got["data_time"] == pytest.approx(0.6, abs=1e-3)

    # two groups of 3; the second's padded slots are its first pair, with
    # its draws, and their results are discarded
    assert [len(c[0]) for c in calls] == [3, 3]
    (g0, d0, r0), (g1, d1, r1) = calls
    assert all(x is g1[0] for x in g1) and all(x is d1[0] for x in d1)
    assert all(a is b for a, b in zip(d0, draws[:3])) and d1[0] is draws[3]
    poses = [r0.pose[u] for u in range(3)] + [r1.pose[0]]
    for j, (inputs, dr) in enumerate(zip([*g0, g1[0]], [*d0, d1[0]])):
        want_res = register_pair(model, inputs, dr, device="cpu")
        assert torch.equal(poses[j], want_res.pose)
        np.testing.assert_allclose(
            np.linalg.inv(traj[j]), poses[j].numpy().astype(np.float64),
            rtol=1e-6, atol=1e-6)


def test_unroll_sweep_without_a_card_raises(capsys):
    """The sweep of ways to run a group measures on the card only: without
    one it raises and prints nothing."""
    from buffer_tpu_torch.utils import unroll_sweep
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        unroll_sweep.main(["--config", "KITTI", "--unroll", "2"])
    assert capsys.readouterr().out == ""
