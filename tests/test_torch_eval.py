"""The port's evaluation path against the JAX package's, on the same inputs:
the metrics and Redwood trajectory files, ``Timer``/``AverageMeter``, the
reference-snapshot loader, ``run_eval`` over the 3DMatch fixture tree, and
the test entry point ``python -m buffer_tpu_torch.scripts.test`` on the
CPU over the three fixture trees (tiny plan).

Tolerances: metrics to 1e-6 relative, recall and precision exactly; in
``run_eval`` equal pair counts, recall and registration recall, and poses
within ``test_torch_registration``'s 1e-3 (JAX held to the TPU kernels'
semantics as there, and fed JAX's draws)."""

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
from buffer_tpu.compat import torch_convert as jtc
from buffer_tpu.data import threedmatch as jtdm
from buffer_tpu.eval import harness as jharness
from buffer_tpu.eval import metrics as jmetrics
from buffer_tpu.models import patch_embedder as jpe
from buffer_tpu.models.composite import BufferModel as JModel
from buffer_tpu.utils import logging as jlogging

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.compat import torch_convert
from buffer_tpu_torch.compat.from_jax import variables_to_state_dict
from buffer_tpu_torch.data import threedmatch
from buffer_tpu_torch.eval import harness, metrics
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.scripts import test as entry
from buffer_tpu_torch.train import checkpoint
from buffer_tpu_torch.utils import logging as tlogging

import fixtures_gen
from test_torch_registration import (_fused_kernel_semantics, _jax_draws,
                                     _tpu_dispatch)

torch.set_num_threads(1)
STAGES = ("Ref", "Desc", "Keypt", "Inlier")


def _with_root(cfg, root):
    return cfg.replace(data=cfg.data.__class__(**{**cfg.data.__dict__,
                                                  "root": root}))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_eval")
    out = {k: str(base / k) for k in ("3dm", "kitti", "eth")}
    for d in out.values():
        os.makedirs(d)
    out["scene"] = fixtures_gen.make_threedmatch_tree(out["3dm"])
    fixtures_gen.make_kitti_tree(out["kitti"])
    fixtures_gen.make_eth_tree(out["eth"])
    return out


def _pose(rs, ang, t):
    axis = rs.randn(3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    a = rs.uniform(0, ang)
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)
    T[:3, 3] = rs.uniform(-t, t, 3)
    return T


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_rte_rre_matches_jax():
    rs = np.random.RandomState(0)
    for _ in range(20):
        pose, gt = _pose(rs, np.pi, 2.0), _pose(rs, np.pi, 2.0)
        np.testing.assert_allclose(metrics.rte_rre(pose, gt),
                                   jmetrics.rte_rre(pose, gt), rtol=1e-6)


def test_compute_transformation_err_matches_jax():
    """20 poses, each with a random positive-definite information matrix;
    the quaternion in fp32 in both packages."""
    rs = np.random.RandomState(1)
    for _ in range(20):
        T = _pose(rs, 0.3, 0.3)
        A = rs.randn(6, 6)
        info = A @ A.T + 6 * np.eye(6)
        np.testing.assert_allclose(
            metrics.compute_transformation_err(T, info),
            jmetrics.compute_transformation_err(T, info), rtol=1e-6)
        q, qj = metrics.mat2quat(T[:3, :3]), jmetrics.mat2quat(T[:3, :3])
        assert q.dtype == qj.dtype == np.float32
        np.testing.assert_allclose(q, qj, rtol=1e-6, atol=1e-7)


def test_evaluate_registration_matches_jax(trees):
    """Recall and precision exactly equal on the fixture's gt.log/gt.info,
    for results perturbed from the ground truth by growing amounts (so that
    the 0.2 threshold decides both ways)."""
    gdir = os.path.join(trees["3dm"], "test", "3DMatch", "gt_result",
                        trees["scene"])
    gt_pairs, gt = metrics.read_trajectory(os.path.join(gdir, "gt.log"))
    n_frag, info = metrics.read_trajectory_info(os.path.join(gdir, "gt.info"))
    pairs = gt_pairs.astype(float).astype(int)
    rs = np.random.RandomState(2)
    seen = set()
    for scale in np.linspace(0.0, 0.3, 20):
        result = np.stack([g @ _pose(rs, scale, scale) for g in gt])
        got = metrics.evaluate_registration(n_frag, result, pairs, pairs, gt,
                                            info)
        want = jmetrics.evaluate_registration(n_frag, result, pairs, pairs,
                                              gt, info)
        assert got == want
        seen.add(got)
    assert len(seen) > 1
    states = np.array([[1, 0.1, 2.0], [0, 0.5, 30.0], [1, 0.2, 4.0]])
    assert metrics.dgr_recall(states) == jmetrics.dgr_recall(states)
    r = metrics.dgr_recall(np.zeros((0, 3)))
    assert r["recall"] == 0.0 and np.isnan(r["TE"])


def test_trajectory_files_match_jax(trees, tmp_path):
    """The readers agree on the fixture's files; est.log written by the port
    is byte-equal to the JAX writer's text, reads back, and is truncated
    on a second write."""
    gdir = os.path.join(trees["3dm"], "test", "3DMatch", "gt_result",
                        trees["scene"])
    log, info = os.path.join(gdir, "gt.log"), os.path.join(gdir, "gt.info")
    a, b = metrics.load_log(log), jmetrics.load_log(log)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for got, want in zip(metrics.read_trajectory(log),
                         jmetrics.read_trajectory(log)):
        np.testing.assert_array_equal(got, want)
    (n, cov), (nj, covj) = (metrics.read_trajectory_info(info),
                            jmetrics.read_trajectory_info(info))
    assert n == nj == 4
    np.testing.assert_array_equal(cov, covj)

    rs = np.random.RandomState(3)
    entries = [(str(i), str(i + 2), np.linalg.inv(_pose(rs, 1.0, 2.0)))
               for i in range(5)]
    ours, theirs = str(tmp_path / "p" / "est.log"), str(tmp_path / "j" / "est.log")
    metrics.write_trajectory(ours, entries)
    metrics.write_trajectory(ours, entries)
    jmetrics.write_trajectory(theirs, entries)
    assert open(ours).read() == open(theirs).read()
    pairs, traj = metrics.read_trajectory(ours)
    assert pairs.shape == (5, 3)
    assert [tuple(p[:2]) for p in pairs] == [e[:2] for e in entries]
    np.testing.assert_allclose(traj, np.stack([e[2] for e in entries]),
                               rtol=1e-6, atol=1e-6)


def test_timer_and_average_meter_match_jax():
    meters = (tlogging.AverageMeter(), jlogging.AverageMeter())
    for v in (3.0, 1.5, 2.25, 7.0):
        for m in meters:
            m.update(v, n=2)
    for key in ("val", "avg", "sum", "sq_sum", "count", "var"):
        assert getattr(meters[0], key) == getattr(meters[1], key)
    t = tlogging.Timer()
    for _ in range(3):
        t.tic()
        time.sleep(0.001)
        t.toc()
    assert t.calls == 3 and t.avg == pytest.approx(t.total_time / 3)
    assert t.toc(average=False) == t.diff


# ---------------------------------------------------------------------------
# reference snapshots
# ---------------------------------------------------------------------------

def _write_snapshot(model, d, drop=None, counter=0):
    """A reference-format snapshot: the whole composite state dict in every
    stage's best.pth, batch-norm counters at ``counter``."""
    sd = {k: (torch.tensor(counter) if k.endswith("num_batches_tracked")
              else v.clone()) for k, v in model.state_dict().items()}
    if drop is not None:
        del sd[drop]
    for s in STAGES:
        os.makedirs(os.path.join(d, s), exist_ok=True)
        torch.save(sd, os.path.join(d, s, "best.pth"))
    return {s: os.path.join(d, s, "best.pth") for s in STAGES}


def test_load_reference_model(tmp_path):
    """The substring merge equals the JAX package's; the loaded model holds
    the snapshot's weights and keeps its own batch-norm counters; the
    snapshot converts through the JAX package's key tables (so it is in the
    reference's key names)."""
    cfg = tconfig.tiny_cfg()
    src = BufferModel(cfg, seed=11)
    paths = _write_snapshot(src, str(tmp_path / "snap"), counter=57)
    merged = torch_convert.load_reference_checkpoint(paths)
    want = jtc.load_reference_checkpoint(paths)
    assert merged.keys() == want.keys()
    for k in merged:
        np.testing.assert_array_equal(merged[k].numpy().astype(np.float32),
                                      want[k])
    model = torch_convert.load_reference_model(cfg, paths, "cpu")
    assert not model.training
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 0
        else:
            assert torch.equal(v, src.state_dict()[k]), k
    back = variables_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jtc.load_variables(paths)))
    for k, v in back.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v, src.state_dict()[k].numpy())


@pytest.mark.parametrize("drop", ["Desc.conv_net.ops.0.weight",
                                  "Inlier.conv.ops.1.running_var",
                                  "Ref.epsilon"])
def test_load_reference_model_raises_on_missing_key(tmp_path, drop):
    cfg = tconfig.tiny_cfg()
    paths = _write_snapshot(BufferModel(cfg), str(tmp_path / "snap"), drop=drop)
    with pytest.raises(KeyError, match="missing"):
        torch_convert.load_reference_model(cfg, paths, "cpu")


def test_load_reference_model_raises_on_unknown_key(tmp_path):
    cfg = tconfig.tiny_cfg()
    paths = _write_snapshot(BufferModel(cfg), str(tmp_path / "snap"))
    sd = torch.load(paths["Keypt"], weights_only=True)
    sd["Keypt.extra.weight"] = torch.zeros(3)
    torch.save(sd, paths["Keypt"])
    with pytest.raises(KeyError, match="unexpected"):
        torch_convert.load_reference_model(cfg, paths, "cpu")


# ---------------------------------------------------------------------------
# run_eval against the JAX harness
# ---------------------------------------------------------------------------

def test_run_eval_matches_jax(trees, monkeypatch, tmp_path):
    """Both harnesses over the 3DMatch fixture tree (3 pairs) at the tiny
    plan, with equal weights and JAX's per-pair draws; JAX registers one
    pair a call (``pair_unroll = 1``, no data parallelism) and is held to
    the TPU kernels' semantics."""
    monkeypatch.setattr(gp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jpe, "fused_point_features", _fused_kernel_semantics)
    _tpu_dispatch(monkeypatch)
    jcfg = _with_root(jconfig.shrink_static(jconfig.make_cfg("3DMatch")),
                      trees["3dm"])
    jcfg = jcfg.replace(static=jcfg.static.__class__(
        **{**jcfg.static.__dict__, "pair_unroll": 1}))
    tcfg = _with_root(tconfig.shrink_static(tconfig.make_cfg("3DMatch")),
                      trees["3dm"])

    variables = jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0))
    model = BufferModel(tcfg)
    model.load_state_dict({k: torch.tensor(v) for k, v in variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)).items()})
    key, subs = jax.random.PRNGKey(0), []
    for _ in range(3):
        key, sub = jax.random.split(key)
        subs.append(sub)
    jlog, tlog = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jharness.run_eval(jcfg, variables, jtdm.ThreeDMatchDataset("test", jcfg),
                             log_dir=jlog, seed=0, use_dp=False)
    got = harness.run_eval(tcfg, model, threedmatch.ThreeDMatchDataset("test", tcfg),
                           log_dir=tlog, seed=0, device="cpu",
                           draws_fn=lambda i: _jax_draws(subs[i], jcfg))
    assert set(got) == set(want)
    assert got["pairs"] == want["pairs"] == 3
    assert got["recall"] == want["recall"]
    assert got["registration_recall"] == want["registration_recall"]
    (pairs, traj), (pairs_j, traj_j) = (
        metrics.read_trajectory(os.path.join(d, trees["scene"], "est.log"))
        for d in (tlog, jlog))
    np.testing.assert_array_equal(pairs, pairs_j)
    # est.log holds inverse poses; compare the poses themselves
    np.testing.assert_allclose(np.linalg.inv(traj), np.linalg.inv(traj_j),
                               rtol=1e-3, atol=1e-3)
    assert got["model_time"] > 0 and got["data_time"] > 0


def test_prefetch_raises_loader_failure():
    """A loader error on the producer thread surfaces in the consumer, and
    the producer stops."""
    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            raise OSError(f"pair {i} unreadable")

    with pytest.raises(OSError, match="pair 0"):
        list(harness._prefetch(tconfig.tiny_cfg(), Broken(), 3,
                               np.random.RandomState(0), tlogging.Timer()))


# ---------------------------------------------------------------------------
# the test entry point
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weight_dirs(tmp_path_factory):
    """One model's weights twice: as this package's per-stage checkpoints
    and as a reference snapshot (whole state dict per stage, counters 9)."""
    base = tmp_path_factory.mktemp("torch_eval_weights")
    model = BufferModel(tconfig.tiny_cfg(), seed=5)
    for s in STAGES:
        checkpoint.save(model, str(base / "own" / s / "best.pth"))
    _write_snapshot(model, str(base / "ref"), counter=9)
    return {"--weights": str(base / "own"), "--torch-weights": str(base / "ref")}


@pytest.mark.parametrize("config,tree,pairs", [("3DMatch", "3dm", 3),
                                               ("KITTI", "kitti", 1),
                                               ("ThreeD2ETH", "eth", 1)])
def test_test_entry_point_on_cpu(trees, weight_dirs, tmp_path, capsys, config,
                                 tree, pairs):
    """``main`` with --tiny --device cpu, once through each weights flag: the
    same model, so the same est.log; the summary and its files."""
    logs = {}
    for flag, d in weight_dirs.items():
        log_dir = str(tmp_path / flag.strip("-"))
        out = entry.main(["--config", config, "--tiny", "--device", "cpu",
                          "--data-root", trees[tree], flag, d,
                          "--log-dir", log_dir])
        assert out["pairs"] == pairs
        assert 0.0 <= out["recall"] <= 1.0 and out["model_time"] > 0
        assert ("registration_recall" in out) == (config == "3DMatch")
        assert "'pairs': %d" % pairs in capsys.readouterr().out
        scene = {"3dm": trees["scene"], "kitti": "08",
                 "eth": "gazebo_summer"}[tree]
        with open(os.path.join(log_dir, scene, "est.log")) as f:
            logs[flag] = f.read()
    assert logs["--weights"] == logs["--torch-weights"]
    if tree == "kitti":
        assert os.path.exists(os.path.join(trees["kitti"], "icp", "8_0_1.npy"))


def test_test_entry_point_needs_weights(trees):
    with pytest.raises(SystemExit):
        entry.main(["--config", "3DMatch", "--device", "cpu",
                    "--data-root", trees["3dm"]])
