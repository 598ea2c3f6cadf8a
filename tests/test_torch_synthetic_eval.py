"""The synthetic evaluation on the CPU: ``data/synthetic.make_lidar_pair``
against the JAX package's generator, ``scripts/synthetic_eval.run_bucket``
against the JAX script's (same pairs, weights and draws, JAX held to the
TPU kernels' semantics as in ``test_torch_registration.py``), its ground-
truth gates, and ``main``'s record, exit code and weights.

At the tiny plan (512 second-downsample points) the buckets' rooms are
scaled down (2500 points over 0.4 m) so that the points the ICP cross-check
reads stay dense enough for its 3DMatch tolerances; ``main`` at ``--tiny``
keeps the full-size rooms and so runs with ``--no-check-gt``."""

import functools
import importlib.util
import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

import buffer_tpu.config as jconfig
import buffer_tpu.kernels.geom_pallas as gp
from buffer_tpu.data import synthetic as jsyn
from buffer_tpu.models import patch_embedder as jpe
from buffer_tpu.models.composite import BufferModel as JModel
from buffer_tpu.pipeline.registration import register_pair as j_register_pair

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.compat.from_jax import variables_to_state_dict
from buffer_tpu_torch.data import synthetic as tsyn
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.models.point_learner import Pyramid
from buffer_tpu_torch.pipeline import registration as tregistration
from buffer_tpu_torch.scripts import synthetic_eval

from test_torch_registration import (_assert_levels_equal,
                                     _assert_tables_equal,
                                     _fused_kernel_semantics, _jax_draws,
                                     _tpu_dispatch)

torch.set_num_threads(1)

STAGES = ("Ref", "Desc", "Keypt", "Inlier")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_synthetic_eval", os.path.join(REPO, "scripts", "synthetic_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("plan", ["tiny", "KITTI"])
@pytest.mark.parametrize("seed,dist,noise,yaw", [(5, 9.5, 0.015, None),
                                                 (6, 12.0, 0.005, 1.3)])
def test_make_lidar_pair_matches_jax(plan, seed, dist, noise, yaw):
    """Points, masks and T equal the JAX package's, array for array."""
    jcfg, tcfg = ((jconfig.tiny_cfg(), tconfig.tiny_cfg()) if plan == "tiny"
                  else (jconfig.kitti_cfg(), tconfig.kitti_cfg()))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, T_want = jsyn.make_lidar_pair(jcfg, np.random.RandomState(seed),
                                            dist=dist, noise=noise, yaw=yaw)
        got, T_got = tsyn.make_lidar_pair(tcfg, np.random.RandomState(seed),
                                          dist=dist, noise=noise, yaw=yaw,
                                          device="cpu")
    np.testing.assert_array_equal(T_got, T_want)
    assert sum(w is not None for w in want) == sum(g is not None for g in got)
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.sds_mask.any()


def _small_rooms(make, **kw):
    """The script's high-overlap bucket at 2500 points over 0.4 m."""
    def gen(cfg, rs, i):
        overlap = rs.uniform(0.45, 0.95)
        noise = rs.uniform(0.0, 0.01)
        clutter = rs.uniform(0.0, 0.1)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            inputs, T = make(cfg, rs, overlap, noise, clutter, n=2500,
                             ext=0.2, **kw)
        return inputs, T, f"overlap={overlap:.2f}"
    return gen


def _torch_pyramid(pj):
    conv = lambda x: (tuple(torch.from_numpy(np.array(a)) for a in x)
                      if isinstance(x, tuple) else torch.from_numpy(np.array(x)))
    return Pyramid(*(conv(getattr(pj, f)) for f in Pyramid._fields))


def test_run_bucket_matches_jax(monkeypatch):
    """Both ``run_bucket``s over 2 rooms of seed 7 with the 3DMatch GT
    cross-check, equal weights and JAX's draws from ``PRNGKey(i)``: per
    pair the same ok and mutual count, RTE and RRE at the registration
    tolerances (pose 1e-3), the same recall.

    Each pair's pyramid must equal JAX's (levels exactly, neighbour tables
    as sets, features to 1e-4) but for the input normals of at most 2
    points a cloud: where a point's 8th and 9th neighbours lie within the
    fp32 rounding of their squared distances (1e-4 relative on these
    rooms), the packages' normal kNN sets differ.  One such normal moves
    the axes and saliency of the whole cloud through the network, so the
    pair then runs on JAX's pyramid, as ``test_torch_registration.py``
    holds such a pair on JAX's tables (ROADMAP.md section 3)."""
    monkeypatch.setattr(gp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jpe, "fused_point_features", _fused_kernel_semantics)
    _tpu_dispatch(monkeypatch)
    jcfg, tcfg = jconfig.tiny_cfg(), tconfig.tiny_cfg()
    jm = JModel(jcfg)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0))
    model = BufferModel(tcfg)
    model.load_state_dict({k: torch.tensor(v) for k, v in variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)).items()})
    check = synthetic_eval.GT_CHECK["3DMatch"]
    reg = jax.jit(lambda v, i, k: j_register_pair(jm, v, i, k,
                                                  return_intermediates=True))
    jax_pyrs = []

    def fn(v, i, k):
        res, inter = reg(v, i, k)
        jax_pyrs.append(inter["pyramid"])
        return res

    want_pp, got_pp = [], []
    want = _jax_script().run_bucket(fn, variables, jcfg,
                                    _small_rooms(jsyn.make_room_pair), 2, 7,
                                    0.3, 15.0, "hi", gt_check=check,
                                    per_pair=want_pp)
    build = tregistration.build_pyramid_and_normals
    pinned = []

    def held(cfg, sds, sds_mask, levels):
        own, pj = build(cfg, sds, sds_mask, levels), jax_pyrs[len(pinned)]
        _assert_levels_equal(own, pj)
        assert not _assert_tables_equal(own, pj)
        off = np.abs(own.features.numpy() - np.asarray(pj.features)).max(-1)
        assert (off > 1e-4).sum(-1).max() <= 2, off.max()
        pinned.append(bool((off > 1e-4).any()))
        return _torch_pyramid(pj) if pinned[-1] else own

    monkeypatch.setattr(tregistration, "build_pyramid_and_normals", held)
    got = synthetic_eval.run_bucket(
        model.eval(), tcfg, _small_rooms(tsyn.make_room_pair, device="cpu"),
        2, 7, 0.3, 15.0, "hi", gt_check=check, per_pair=got_pp,
        draws_fn=lambda i: _jax_draws(jax.random.PRNGKey(i), jcfg),
        device="cpu")
    assert len(pinned) == 2
    assert got == want
    for g, w in zip(got_pp, want_pp):
        assert (g["ok"], g["mutual"], g["desc"]) == (w["ok"], w["mutual"],
                                                     w["desc"])
        assert g["mutual"] > 0
        assert abs(g["rte"] - w["rte"]) <= 2e-3
        assert abs(g["rre"] - w["rre"]) <= 0.1


def test_gt_cross_check_raises_on_doubled_translation():
    """A generator whose ground truth doubles the translation (the bug
    class the JAX script guards) fails the cross-check before any pair is
    registered; the right ground truth passes it."""
    cfg = tconfig.tiny_cfg()
    good = _small_rooms(tsyn.make_room_pair, device="cpu")

    def doubled(cfg, rs, i):
        inputs, T, desc = good(cfg, rs, i)
        T = T.copy()
        T[:3, 3] *= 2
        return inputs, T, desc

    check = synthetic_eval.GT_CHECK["3DMatch"]
    model = BufferModel(cfg).eval()
    with pytest.raises(RuntimeError, match="cross-check"):
        synthetic_eval.run_bucket(model, cfg, doubled, 3, 7, 0.3, 15.0, "hi",
                                  gt_check=check, device="cpu")
    recall, n = synthetic_eval.run_bucket(model, cfg, good, 3, 7, 0.3, 15.0,
                                          "hi", gt_check=check, device="cpu")
    assert n == 3 and 0.0 <= recall <= 1.0


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """Seeded random weights at the tiny plan as a reference snapshot."""
    d = tmp_path_factory.mktemp("synthetic_snapshot")
    sd = BufferModel(tconfig.tiny_cfg(), seed=3).state_dict()
    for s in STAGES:
        os.makedirs(d / s)
        torch.save(sd, d / s / "best.pth")
    return str(d)


def test_main_record_matches_jax_fields(snapshot, tmp_path, monkeypatch,
                                        capsys):
    """``main --tiny --device cpu`` over 1 + 1 rooms: the JSON record has
    the JAX script's fields (its own run at the tiny plan, weights swapped
    in), the per-pair lines agree with it, and ``--exact`` adds the same
    settings."""
    common = ["--pairs", "1", "--low-pairs", "1", "--no-check-gt"]
    runs = {}
    for name, extra in (("shipped", []), ("exact", ["--exact", "--buckets",
                                                    "high"])):
        rec, pp = str(tmp_path / f"{name}.json"), str(tmp_path / f"{name}.pp")
        rc = synthetic_eval.main([*common, *extra, "--tiny", "--device", "cpu",
                                  "--torch-weights", snapshot, "--json", rec,
                                  "--per-pair-json", pp])
        assert rc == 0
        with open(rec) as f:
            runs[name] = [json.loads(ln) for ln in f]
        with open(pp) as f:
            runs[name + "_pp"] = [json.loads(ln) for ln in f]

    import buffer_tpu.compat.torch_convert as jtc
    jcfg = jconfig.shrink_static(jconfig.make_cfg("3DMatch"))
    monkeypatch.setattr(jconfig, "make_cfg", lambda name: jcfg)
    monkeypatch.setattr(jtc, "load_variables", lambda paths: jax.jit(
        JModel(jcfg).init)(jax.random.PRNGKey(0)))
    jrec = str(tmp_path / "jax.json")
    monkeypatch.setattr("sys.argv", ["synthetic_eval.py", *common,
                                     "--json", jrec])
    assert _jax_script().main() == 0
    with open(jrec) as f:
        (want,) = [json.loads(ln) for ln in f]
    capsys.readouterr()

    (got,) = runs["shipped"]
    assert got.keys() == want.keys()
    assert got["buckets"].keys() == want["buckets"].keys()
    for k in ("metric", "unit", "pairs", "config"):
        assert got[k] == want[k], k
    for b, rec in got["buckets"].items():
        assert rec.keys() == want["buckets"][b].keys()
        pp = [p for p in runs["shipped_pp"] if p["bucket"] == b]
        assert rec["pairs"] == len(pp)
        assert rec["recall"] == round(float(np.mean([p["ok"] for p in pp])), 4)
    (exact,) = runs["exact"]
    assert exact["settings"] == {"exact": True, "refine_iters": 20,
                                 "hypotheses": 4096, "knn_band": 0,
                                 "fused_desc": False}
    assert list(exact["buckets"]) == ["overlap_045_095"]


def test_main_assert_recall_and_missing_weights(snapshot, tmp_path):
    """``--assert-recall`` above the recall makes the exit code 1; a missing
    snapshot raises, never falling back to random weights."""
    args = ["--config", "KITTI", "--pairs", "1", "--tiny", "--device", "cpu",
            "--no-check-gt"]
    assert synthetic_eval.main([*args, "--torch-weights", snapshot,
                                "--assert-recall", "1.01"]) == 1
    with pytest.raises(FileNotFoundError):
        synthetic_eval.main([*args, "--torch-weights", str(tmp_path / "none")])
    with pytest.raises(FileNotFoundError):
        synthetic_eval.main([*args, "--reference-root", str(tmp_path)])
