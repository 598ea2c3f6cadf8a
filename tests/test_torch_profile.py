"""The measurement entry points of the port on the CPU at tiny plans: the
profile rows of ``scripts/profile_stages.py`` and ``profile_micro.py``
chained against the eager pair and the modules they split (bit for bit),
the tail rows against the JAX functions that the repository's
``scripts/profile_stages.py`` times (weights through the JAX package's
``convert_state_dict``, the tolerances of ``test_torch_registration.py``),
the trace analysis against the JAX script's depth-1 merge (loaded from its
file), the profiling helpers, ``sanity_pair`` on the CPU, and the
card-only entry points raising without a card."""

import copy
import dataclasses
import gzip
import importlib.util
import json
import os
import pathlib
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import buffer_tpu.config as jconfig
from buffer_tpu.compat.torch_convert import convert_state_dict
from buffer_tpu.models.composite import BufferModel as JModel
from buffer_tpu.pipeline import matching as jmatching
from buffer_tpu.pipeline import ransac as jransac
from buffer_tpu.pipeline import refine as jrefine

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.compat.from_jax import variables_to_state_dict
from buffer_tpu_torch.data.preprocess import prepare_pair
from buffer_tpu_torch.data.synthetic import bench_pair, surface_pair
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.nn.cylindrical import CostNet
from buffer_tpu_torch.pipeline import registration as reg
from buffer_tpu_torch.pipeline.train_forward import make_train_draws
from buffer_tpu_torch.scripts import (analyze_trace, capture_trace,
                                      capture_train_trace, profile_micro,
                                      profile_stages, profile_train,
                                      sanity_pair)
from buffer_tpu_torch.train.trainer import TrainBatch
from buffer_tpu_torch.utils import profiling

from test_torch_program import HostTraffic
from test_torch_registration import _surface

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SHIFT = [0.02, -0.01, 0.015]


def _plan(name):
    """The tiny plan of a case: 3DMatch's base budget, 3DMatch with the
    low-match budget on and taken (``low_match_th`` above any count), the
    shrunk KITTI preset."""
    if name == "KITTI":
        return tconfig.shrink_static(tconfig.kitti_cfg())
    c = tconfig.tiny_cfg()
    if name == "3DMatch boost":
        c = c.replace(static=dataclasses.replace(
            c.static, low_match_boost=True, low_match_th=10 ** 6))
    return c


def _pair(cfg, seed=0):
    """prepare_pair of a wavy surface and its shifted copy (KITTI: ten
    times the extent and shift), so that random weights still match."""
    scale = np.float32(10.0 if cfg.data.dataset == "KITTI" else 1.0)
    raw = _surface(900, seed, extent=0.6 * float(scale))
    return prepare_pair(cfg, raw, raw + np.float32([0.02, -0.01, 0.015]) * scale,
                        rs=np.random.RandomState(3), already_downsampled=True,
                        device="cpu")


def _budgets(cfg):
    return (False, True) if cfg.static.low_match_boost else (False,)


def _equal(a, b):
    la, lb = (torch.utils._pytree.tree_leaves(x) for x in (a, b))
    return len(la) == len(lb) > 0 and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("case", ["3DMatch", "3DMatch boost", "KITTI"])
def test_stage_rows_chain_to_register_pair(case):
    """The stage rows, each run on the rows before it, give
    ``register_pair``'s intermediates, pose and RANSAC inlier count bit for
    bit, and every other budget's rows ``pair_tail`` of that budget."""
    cfg = _plan(case)
    model = BufferModel(cfg, seed=0).eval()
    inputs = _pair(cfg)
    draws = reg.make_draws(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad(), reg.full_fp32():
        rows = profile_stages.stage_bodies(model, inputs, draws, _budgets(cfg))
        chained = profile_stages.chain_results(rows)
    names = [r.name for r in rows]
    assert names[:8] == ["pyramid + normals", "EFCNN (Ref)", "DetNet (Keypt)",
                         "threshold + FPS", "MiniSpinNet (both clouds)",
                         "mutual matching", "cost volume", "hypotheses + voting"]
    kinds = ("RANSAC", "IRLS") if cfg.test.pose_refine else ("RANSAC",)
    assert names[8:] == [f"{kind} ({profile_stages.budget_name(b)})"
                         for b in _budgets(cfg) for kind in kinds]
    inter, tails = chained
    res, want = reg.register_pair(model, inputs, draws, device="cpu",
                                  return_intermediates=True)
    assert inter.keys() == want.keys()
    for k in want:
        assert _equal(inter[k], want[k]), k
    taken = reg.boost_taken(cfg, res.num_mutual)
    assert taken == (case == "3DMatch boost") and int(res.num_mutual) > 0
    pose, n_inl = tails[taken]
    assert torch.equal(pose, res.pose) and torch.equal(n_inl, res.num_inliers)
    with torch.no_grad():
        front, _ = reg.pair_front(model, inputs, draws)
        for b in tails:
            w_pose, w_inl = reg.pair_tail(cfg, front, *reg.tail_budget(cfg, draws, b))
            assert torch.equal(tails[b][0], w_pose) and torch.equal(tails[b][1], w_inl)
    assert profile_stages.chain_mismatches(model, inputs, draws, chained, "cpu") == []
    # the taken tail's Kabsch calls: the hypotheses, the refit, one an IRLS
    # round (KITTI does not refine)
    H = draws.ransac_gumbel_boost.shape[0] if taken else cfg.match.hypotheses
    K = cfg.point.num_keypts
    calls = profile_stages.kabsch_calls(rows, profile_stages.budget_name(taken))
    want = [("RANSAC", [H, 3, 3], False, 1), ("RANSAC", [1, K, 3], True, 1)]
    if cfg.test.pose_refine:
        want.append(("IRLS", [1, K, 3], True, reg.tail_budget(cfg, draws, taken)[1]))
    assert [(c["row"].split()[0], c["points"], c["weighted"], c["calls"])
            for c in calls] == want


@pytest.mark.parametrize("which", ["stage", "micro"])
def test_rows_are_capture_safe(which):
    """Each row's body, after an eager run, makes no host read, builds no
    tensor from host data and takes no data-dependent shape: what the
    card's CUDA graph capture of ``graph_time`` would refuse."""
    cfg = _plan("3DMatch boost")
    model = BufferModel(cfg, seed=0).eval()
    inputs = _pair(cfg, 1)
    draws = reg.make_draws(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad(), reg.full_fp32():
        if which == "stage":
            rows = profile_stages.stage_bodies(model, inputs, draws, (False, True))
        else:
            rows = profile_micro.micro_bodies(model, inputs, draws)
        for r in rows:
            with HostTraffic() as traffic:
                r.body()
            assert traffic.found == [], r.name


def test_micro_rows_chain_to_the_modules():
    """The micro rows give ``model.Ref``'s axis, eps and branch,
    ``model.Keypt``'s saliency and ``describe_both``'s descriptors, maps and
    frames bit for bit; the convolution rows compose to ``CylindricalNet``
    and ``CostNet``; the cost volume's FLOPs are ``CostNet.PLAN``'s
    multiply-adds, counted here from the layer shapes."""
    cfg = _plan("3DMatch")
    model = BufferModel(cfg, seed=0).eval()
    inputs = _pair(cfg)
    draws = reg.make_draws(cfg, torch.Generator().manual_seed(0), "cpu")
    K = cfg.point.num_keypts
    with torch.no_grad(), reg.full_fp32():
        rows = profile_micro.micro_bodies(model, inputs, draws)
        out = {r.name: r.body() for r in rows}
        res, inter = reg.register_pair(model, inputs, draws, device="cpu",
                                       return_intermediates=True)
        pyr = inter["pyramid"]
        axis, eps, branch = model.Ref(pyr)
        (s_des, s_equi, s_R), (t_des, t_equi, t_R) = reg.describe_both(
            model, cfg, draws, inputs.raw, inputs.raw_mask, inter["kpts"],
            inter["kaxes"])
        pooled = out["fused front (SPT)"]
        cyl = model.Desc.conv_net(pooled.permute(0, 4, 1, 2, 3))
        band = slice(1, cfg.patch.ele_n - 1)
        tgt = inter["matches"].tgt_idx.long()
        cost = model.Inlier.conv(model.Inlier.cost(s_equi[:, band],
                                                   t_equi[:, band][tgt]))
    assert _equal(out["EFCNN heads (axis + inv)"], (axis, eps))
    assert _equal(out["EFCNN block 0"], branch["skips"][0])
    assert _equal(out["EFCNN block 2"], branch["skips"][1])
    assert _equal(out["EFCNN block 4"], branch["bottle"])
    assert _equal(out["DetNet (Keypt)"][..., 0], inter["score"])
    desc, equi = out["MiniSpinNet network"]
    assert _equal((desc[:K], equi[:K], out["axis align"][:K]), (s_des, s_equi, s_R))
    assert _equal((desc[K:], equi[K:], out["axis align"][K:]), (t_des, t_equi, t_R))
    assert _equal(out["cylindrical conv 7"], cyl)
    assert _equal(out["cost volume conv 9"].reshape(K, -1), cost)
    assert _equal(cost, model.Inlier.conv(model.Inlier.cost(
        inter["s_equi"][:, band], inter["t_equi"][:, band][tgt])))
    assert profile_micro.chain_mismatches(model, inputs, draws, rows) == []

    shape, macs = (20, 5, 20), 0
    for cin, cout, k in CostNet.PLAN + ((32, 20, (2, 1, 2)),):
        shape = tuple(s - kk + 1 for s, kk in zip(shape, k))
        macs += cout * cin * int(np.prod(k)) * int(np.prod(shape))
    flops = [r.flops for r in rows if r.name.startswith("cost volume conv")]
    assert len(flops) == 10 and sum(flops) == 2 * macs * K
    assert round(macs / 1e6, 1) == 80.0
    assert len([r for r in rows if r.name.startswith("cylindrical conv")]) == 8


@pytest.fixture(scope="module", params=["random", "steered"])
def tail_rows(request):
    """The tiny plan's stage rows on one prepared cloud and its copy moved
    by a translation (so that true matches exist whatever the weights),
    with the same ball priorities for both; the port holds JAX's initial
    weights (``variables_to_state_dict``), JAX's model the port's weights
    through ``convert_state_dict``; the RANSAC draws are a JAX key's.
    Random weights give every match a random azimuth, and voting then keeps
    a match or two; "steered" adds 8 to the last CostNet bias of bin 0, so
    that the hypotheses of true matches agree and RANSAC has inliers."""
    jcfg, cfg = jconfig.tiny_cfg(), tconfig.tiny_cfg()
    jm = JModel(jcfg)
    model = BufferModel(cfg).eval()
    model.load_state_dict({k: torch.tensor(v) for k, v in variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    ).items()})
    if request.param == "steered":
        with torch.no_grad():
            model.Inlier.conv.ops[-1].bias[0] += 8.0
    params, stats = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    variables = {s: {"params": jax.tree_util.tree_map(jnp.asarray, params[s]),
                     "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats[s])}
                 for s in params}
    key = jax.random.PRNGKey(5)
    draws = reg.make_draws(cfg, torch.Generator().manual_seed(0), "cpu")
    gumbel = jax.random.gumbel(key, (cfg.match.hypotheses, 3, cfg.point.num_keypts))
    draws = draws._replace(ransac_gumbel=torch.from_numpy(np.array(gumbel)),
                           ball_prio=draws.ball_prio[:1].expand(2, -1).contiguous())
    raw = _surface(500, 0)
    inputs = prepare_pair(cfg, raw, raw.copy(), rs=np.random.RandomState(3),
                          already_downsampled=True, device="cpu")
    moved = lambda t: torch.stack([t[0], t[1] + torch.tensor(SHIFT)])
    inputs = inputs._replace(**{f: moved(getattr(inputs, f))
                                for f in ("raw", "sds", "lvl1", "lvl2")})
    with torch.no_grad(), reg.full_fp32():
        rows = profile_stages.stage_bodies(model, inputs, draws, (False,))
        out = {r.name: r.body() for r in rows}
    return request.param, jcfg, jm, variables, key, out


def _j(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("row", ["cost volume", "hypotheses + voting",
                                 "RANSAC (base)", "IRLS (base)"])
def test_tail_rows_match_jax(tail_rows, row):
    """Each tail row against the JAX function the JAX script times for it,
    on the row's own inputs: ``Inlier.apply`` (1e-3), ``pose_hypotheses``
    and ``vote_hypotheses`` (the winner and its inliers exactly),
    ``ransac_pose`` with the key whose Gumbel draws the row took (inliers
    exactly, pose 1e-3), ``post_refinement`` from the RANSAC row's pose
    (1e-3)."""
    weights, jcfg, jm, variables, key, out = tail_rows
    _, kvalid, kpts, _ = out["threshold + FPS"]
    (_, s_equi, s_R), (_, t_equi, _) = out["MiniSpinNet (both clouds)"]
    m, tgt, tt_kpts, tt_R, _ = out["mutual matching"]
    ind = out["cost volume"]
    R_h, t_h, best, vote_inliers = out["hypotheses + voting"]
    ss = kpts[0]
    assert int(m.mutual.sum()) > 0
    if weights == "steered":
        assert int(vote_inliers.sum()) >= 3 and int(out["RANSAC (base)"][1].sum()) >= 3
    if row == "cost volume":
        band = slice(1, jcfg.patch.ele_n - 1)
        want = jm.Inlier.apply(variables["Inlier"], _j(s_equi[:, band]),
                               _j(t_equi[:, band][tgt]))
        np.testing.assert_allclose(ind.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-3)
    elif row == "hypotheses + voting":
        Rj, tj = jmatching.pose_hypotheses(_j(ss), _j(tt_kpts), _j(s_R),
                                           _j(tt_R), _j(ind), jcfg.patch.azi_n)
        bj, inl_j = jmatching.vote_hypotheses(
            _j(ss), _j(tt_kpts), Rj, tj, _j(m.mutual), jcfg.patch.azi_n,
            jcfg.match.inlier_th)
        np.testing.assert_allclose(R_h.numpy(), np.asarray(Rj), rtol=1e-5, atol=1e-5)
        assert int(best) == int(bj)
        np.testing.assert_array_equal(vote_inliers.numpy(), np.asarray(inl_j))
    elif row == "RANSAC (base)":
        pose, inl = out[row]
        pj, inl_j = jransac.ransac_pose(key, _j(ss), _j(tt_kpts), _j(vote_inliers),
                                        jcfg.match.dist_th, jcfg.match.similar_th,
                                        jcfg.match.hypotheses)
        np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_j))
        np.testing.assert_allclose(pose.numpy(), np.asarray(pj), rtol=1e-3, atol=1e-3)
    else:
        pose_in, _ = out["RANSAC (base)"]
        want = jrefine.post_refinement(_j(pose_in), _j(ss), _j(tt_kpts),
                                       _j(m.mutual), 0.10,
                                       iters=jcfg.static.refine_iters)
        np.testing.assert_allclose(out[row].numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-3)
        # the refinement finds the translation between the clouds
        np.testing.assert_allclose(out[row][:3, 3].numpy(), SHIFT, atol=1e-4)


def _jax_analyze():
    spec = importlib.util.spec_from_file_location(
        "jax_analyze_trace", REPO / "scripts" / "analyze_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", range(5))
def test_depth1_matches_the_jax_script(seed):
    """On random event lists with nested, overlapping and equal-start
    events, the depth-1 merge counts the length of the union of their
    intervals; on the events that the JAX script's ``depth1`` keeps, with
    those nested in them, it keeps the JAX script's events, each in full."""
    rs = np.random.RandomState(seed)
    n = 60
    events = [{"name": f"k{i}", "ts": int(rs.randint(0, 40)),
               "dur": int(rs.randint(0, 15))} for i in range(n)]
    events += [dict(e, name=e["name"] + "n", dur=max(e["dur"] - 3, 0))
               for e in events[:10]]                     # nested, equal start
    got = analyze_trace.depth1(copy.deepcopy(events))
    union = set().union(*(range(e["ts"], e["ts"] + e["dur"]) for e in events))
    assert sum(us for _, us in got) == len(union)
    assert 0 < len(got) < len(events)
    assert all(0 < us <= e["dur"] or us == e["dur"] == 0 for e, us in got)

    jax_depth1 = _jax_analyze().depth1
    kept = jax_depth1(copy.deepcopy(events))
    nested = [e for e in events if any(
        k["ts"] <= e["ts"] and e["ts"] + e["dur"] <= k["ts"] + k["dur"]
        for k in kept)]
    want = jax_depth1(copy.deepcopy(nested))
    got = analyze_trace.depth1(copy.deepcopy(nested))
    assert [e for e, _ in got] == want and want == kept
    assert all(us == e["dur"] for e, us in got)


def _write_trace(path, events):
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_analyze_aggregates_a_small_trace(tmp_path, capsys):
    """On a hand-made trace: only device events launched inside the widest
    ``replays`` span count (by correlation id: one dated past the span's
    end counts, one dated inside it but launched after it does not), a
    nested one not at all, one starting before the previous one ends for
    its time past it; kernels aggregate by base name (``--exact``: by full
    name), per iteration; a directory gives its newest trace."""
    def X(name, cat, ts, dur, corr=None):
        e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
             "pid": 0, "tid": 0}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    events = [
        X("replays", "user_annotation", 100, 1000),
        X("replays", "user_annotation", 1500, 10),
        X("cudaGraphLaunch", "cuda_runtime", 105, 5, corr=1),
        X("cudaMemcpyAsync", "cuda_runtime", 390, 5, corr=2),
        X("cudaLaunchKernel", "cuda_runtime", 1095, 10, corr=3),  # runs past
        X("cudaLaunchKernel", "cuda_runtime", 1150, 5, corr=4),   # after
        X("void ns::k<4, float>(int, float*)", "kernel", 110, 100, corr=1),
        X("void ns::k<4, float>(int, float*)", "kernel", 120, 10, corr=1),
        X("void ns::k<2, int>(int)", "kernel", 300, 50, corr=1),
        X("void tail(int)", "kernel", 340, 20, corr=1),          # 10 past
        X("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 400, 20, corr=2),
        X("void ns::k<2, int>(int)", "kernel", 1140, 30, corr=1),  # dated late
        X("void other(int)", "kernel", 1060, 5, corr=4),
        X("void other(int)", "kernel", 1200, 30, corr=3),
        X("void other(int)", "kernel", 1300, 30),
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 0,
         "args": {"name": "stream 7"}},
    ]
    old = tmp_path / "1.trace.json.gz"
    _write_trace(old, [X("replays", "user_annotation", 0, 5)])
    os.utime(old, (time.time() - 60, time.time() - 60))
    _write_trace(tmp_path / "2.trace.json.gz", events)
    out = analyze_trace.analyze(analyze_trace.trace_path(str(tmp_path)), iters=2)
    assert out["trace"].endswith("2.trace.json.gz")
    assert out["events"] == 5 and out["total_ms"] == pytest.approx(0.21)
    assert out["ms_per_iter"] == pytest.approx(0.105)
    assert out["in_part"] == 1 and out["in_part_ms_per_iter"] == pytest.approx(0.01)
    assert out["late_ms"] == pytest.approx(0.07)
    assert [(r["name"], r["ms_per_iter"], r["count_per_iter"]) for r in out["rows"]] \
        == [("ns::k", pytest.approx(0.09), 1.5),
            ("Memcpy HtoD", pytest.approx(0.01), 0.5),
            ("tail", pytest.approx(0.005), 0.5)]
    exact = analyze_trace.analyze(str(tmp_path / "2.trace.json.gz"), 2, exact=True)
    assert [r["name"] for r in exact["rows"]] == [
        "void ns::k<4, float>(int, float*)", "void ns::k<2, int>(int)",
        "Memcpy HtoD (Pageable -> Device)", "void tail(int)"]
    assert analyze_trace.main([str(tmp_path), "--iters", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("depth-1: 5 events, 0.210 ms total -> 0.105 ms/iter")
    assert json.loads(lines[-1])["ms_per_iter"] == pytest.approx(0.105)


def test_base_name():
    assert analyze_trace.base_name(
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl"
        "<at::native::FillFunctor<float> >(at::TensorIteratorBase&, "
        "at::native::FillFunctor<float> const&)::{lambda(int)#1}>(int, "
        "at::native::gpu_kernel_impl<at::native::FillFunctor<float> >("
        "at::TensorIteratorBase&)::{lambda(int)#1})") \
        == "at::native::elementwise_kernel"
    assert analyze_trace.base_name("bknn_kernel") == "bknn_kernel"
    assert analyze_trace.base_name("Memset (Device)") == "Memset"
    assert analyze_trace.base_name(
        "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nchw") \
        == "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nchw"


def test_trace_and_annotate_write_a_cpu_trace(tmp_path):
    """``trace`` writes a gzipped Chrome trace holding the ``annotate``
    span; ``trace(None)`` records nothing."""
    with profiling.trace(str(tmp_path)) as path:
        with profiling.annotate("replays"):
            torch.ones(64).sum()
    assert os.path.exists(path) and path.endswith(".trace.json.gz")
    assert analyze_trace.trace_path(str(tmp_path)) == path
    names = {(e.get("cat"), e.get("name"))
             for e in analyze_trace.load_events(path)}
    assert ("user_annotation", "replays") in names
    with profiling.trace(None) as none:
        assert none is None
    assert os.listdir(tmp_path) == [os.path.basename(path)]


def test_step_timer_median():
    timer = profiling.StepTimer()
    assert np.isnan(timer.median)
    with timer.measure():
        time.sleep(0.01)
    assert len(timer.times) == 1 and timer.times[0] >= 0.01
    timer.times = [3.0, 1.0, 2.0, 5.0, 4.0]
    assert timer.median == 3.0


CARD_ONLY = {
    "graph_time": lambda: profiling.graph_time(lambda: torch.ones(1)),
    "replay_time": lambda: profiling.replay_time(lambda: None),
    "profile_stages": lambda: profile_stages.main([]),
    "profile_micro": lambda: profile_micro.main([]),
    "profile_train": lambda: profile_train.main(["--stages", "Ref"]),
    "capture_trace": lambda: capture_trace.main([]),
    "capture_train_trace": lambda: capture_train_trace.main([]),
    "sanity_pair": lambda: sanity_pair.main([]),
}


@pytest.mark.parametrize("name", list(CARD_ONLY))
def test_card_only_entry_points_raise_without_a_card(name):
    """Without a card the timing helpers and the entry points raise; none
    falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CARD_ONLY[name]()


def test_sanity_pair_on_the_cpu_equals_register_pair(capsys):
    """``sanity_pair --tiny --device cpu`` prints, for each seed, the RTE,
    RRE and counts of ``register_pair`` on that seed's pair (``bench_pair``:
    ``bench.synthetic_pair``'s, as the JAX script takes) and draws with
    seeded random weights, and says the weights are random."""
    assert sanity_pair.main(["--tiny", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert got["weights"] == "random, seed 0" and got["device"] == "cpu"
    cfg = tconfig.shrink_static(tconfig.make_cfg("3DMatch"))
    model = BufferModel(cfg, seed=0).eval()
    assert [p["seed"] for p in got["pairs"]] == list(sanity_pair.SEEDS)
    for p in got["pairs"]:
        inputs, T = bench_pair(cfg, "cpu", p["seed"])
        draws = reg.make_draws(cfg, torch.Generator().manual_seed(p["seed"]), "cpu")
        res = reg.register_pair(model, inputs, draws, device="cpu")
        pose = res.pose.double().numpy()
        rte = float(np.linalg.norm(pose[:3, 3] - T[:3, 3]))
        cos = (np.trace(pose[:3, :3].T @ T[:3, :3]) - 1.0) / 2.0
        rre = float(np.degrees(np.arccos(np.clip(cos, -1 + 1e-16, 1 - 1e-16))))
        assert (p["mutual"], p["inliers"]) == (int(res.num_mutual),
                                               int(res.num_inliers))
        assert p["rte_m"] == rte and p["rre_deg"] == rre


def test_precision_relative_l2():
    """0 on equal gradients; a gradient scaled by 1.25 is 0.25 off."""
    g = [torch.randn(3, 4, generator=torch.Generator().manual_seed(0)),
         torch.arange(5.0)]
    assert profile_train.rel_l2(g, [t.clone() for t in g]) == 0.0
    assert profile_train.rel_l2([1.25 * t for t in g], g) == pytest.approx(0.25)


def test_precision_check_on_the_cpu_is_exact():
    """On the CPU the TF32 switches change nothing: the check reads 0 and
    equal losses, and the running statistics are put back."""
    cfg = tconfig.tiny_cfg()
    inputs, T = surface_pair(cfg, 0, "cpu")
    batch = TrainBatch(inputs, torch.as_tensor(T))
    draws = make_train_draws(cfg, torch.Generator().manual_seed(0), "cpu")
    model = BufferModel(cfg, seed=0)
    before = [b.clone() for b in model.buffers()]
    loss, grads = profile_train.stage_grads(model, "Ref", batch, draws, 1.05,
                                            tf32=True)
    assert torch.isfinite(loss) and any(g.abs().sum() > 0 for g in grads)
    assert all(torch.equal(a, b) for a, b in zip(model.buffers(), before))
    (row,) = profile_train.precision_check(cfg, batch, draws, ["Ref"], 1.05)
    assert row["grad_rel_l2"] == 0.0 and row["loss_tf32"] == row["loss_fp32"]
