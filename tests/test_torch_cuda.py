"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and skip without one (a CUDA kernel has no
CPU mode).  The file imports neither JAX nor the JAX package, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from buffer_tpu_torch.config import threedmatch_cfg, tiny_cfg
from buffer_tpu_torch.data.preprocess import morton_sort
from buffer_tpu_torch.data.synthetic import surface_pair
from buffer_tpu_torch.kernels import cuda, fps_cuda, geom_cuda, knn_cuda, sites
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.pipeline import registration


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain(card):
    """Each CUDA kernel against its plain version on the card: exact for
    1-NN, FPS and ball sampling, 2e-5 for the SPT front."""
    cuda.build_all()
    rs = np.random.RandomState(4)
    g = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(card)
    pts, q = g(2, 4096, 3), g(2, 1000, 3)
    valid = torch.from_numpy(rs.rand(2, 4096) > 0.1).to(card)
    for got, want in zip(geom_cuda.nearest_cuda(q, pts, valid),
                         geom_cuda.nearest_plain(q, pts, valid)):
        assert torch.equal(got, want)
    assert torch.equal(fps_cuda.fps_cuda_batched(pts, valid, 200),
                       fps_cuda.fps_plain(pts, valid, 200))
    prio = torch.rand((2, 4096), device=card)
    for got, want in zip(
            geom_cuda.ball_sample_planes_cuda(q, pts, valid, prio, 0.8, 64),
            geom_cuda.ball_sample_planes_plain(q, pts, valid, prio, 0.8, 64)):
        assert torch.equal(got, want)
    planes = tuple(g(100, 512) * 0.4 for _ in range(3))
    R = torch.linalg.qr(g(100, 3, 3))[0].contiguous()
    args = (g(20, 3, 16), g(16), torch.relu(g(16)), torch.rand(512, device=card),
            planes, R, 3, 20, 7, 0.8 / 3, 10)
    torch.testing.assert_close(geom_cuda.spt_pooled_cuda(*args),
                               geom_cuda.spt_pooled_plain(*args),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Q,N,k", [(2, 512, 65536, 512), (3, 13, 3072, 64)])
def test_ball_sample_points_kernel_matches_plain(card, B, Q, N, k):
    """The training front's ball sampling bit for bit against its plain
    version: the full-width 3DMatch shape (both clouds' 512 patches of 512
    points from 65536) and a ragged one (a partial query tile, invalid
    support points)."""
    cuda.build_all()
    rs = np.random.RandomState(9)
    sup = torch.from_numpy(rs.uniform(-1.5, 1.5, (B, N, 3)).astype(np.float32))
    valid = torch.from_numpy(rs.rand(B, N) > 0.1)
    q = sup[:, torch.from_numpy(rs.choice(N, Q, replace=False))]
    prio = torch.from_numpy(rs.rand(B, N).astype(np.float32))
    args = [t.to(card) for t in (q, sup, valid, prio)] + [0.3, k]
    before = cuda.launch_counts()["ball_sample_points"]
    got = geom_cuda.ball_sample_points_cuda(*args)
    torch.cuda.synchronize()
    assert cuda.launch_counts()["ball_sample_points"] == before + 1
    want = geom_cuda.ball_sample_points_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[1].any() and not got[1].all()


def _fps_cloud(N, B, seed):
    """B clouds of N points with eligibility holes (a run and scattered
    points) and exact duplicates across the first and last CTAs of the
    plan: a far pair that ties on the first step and a copied block."""
    rs = np.random.RandomState(seed)
    pts = rs.randn(B, N, 3).astype(np.float32)
    elig = rs.rand(B, N) > 0.2
    elig[:, N // 3:N // 3 + N // 10] = False
    if N >= 64:
        C, T, P = fps_cuda.fps_plan(N)
        j = (C - 1) * T * P + 1 if C > 1 else N - 1   # the last CTA's share
        pts[:, 2] = pts[:, j] = (30.0, 30.0, -30.0)
        elig[:, [2, j]] = True
        n = min(N // 8, N - j - 1)
        pts[:, j + 1:j + 1 + n] = pts[:, 5:5 + n]
    return pts, elig


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("N", [1, 31, 1024, 1025, 8192, 30720, 40960, 65536])
def test_fps_cluster_kernel_matches_plain(card, N, B):
    """The cluster FPS bit-equal to its plain version at every fps_plan
    boundary, with ties across CTAs and eligibility holes; fewer points
    than samples at the small sizes.  One launch each."""
    cuda.build_all()
    pts, elig = (torch.from_numpy(a).to(card) for a in _fps_cloud(N, B, N + B))
    S = 48 if N < 64 else 256
    before = cuda.launch_counts()["fps"]
    got = fps_cuda.fps_cuda_batched(pts, elig, S)
    torch.cuda.synchronize()
    assert cuda.launch_counts()["fps"] == before + 1
    want = fps_cuda.fps_plain(pts, elig, S)
    assert torch.equal(got, want)
    if N >= 64:
        assert (got[:, 1] == 2).all()          # the tie goes to the lower index
    single = fps_cuda.fps_cuda_single(pts[0], elig[0], S)
    assert torch.equal(single, want[0])


@pytest.mark.cuda
def test_fps_bad_plan_raises(card, monkeypatch):
    """A plan the launcher does not take raises (no fallback): more threads
    than the register budget of 16 points a thread allows."""
    cuda.build_all()
    monkeypatch.setattr(fps_cuda, "fps_plan", lambda N: (8, 1024, 16))
    pts = torch.zeros((1, 65536, 3), device=card)
    with pytest.raises(RuntimeError):
        fps_cuda.fps_cuda_batched(pts, torch.ones((1, 65536), dtype=torch.bool,
                                                  device=card), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [100, 2999])
def test_spt_kernel_matches_plain_ragged(card, K):
    """The SPT kernel against its plain version (2e-5) at keypoint counts
    that leave a ragged last block (3 keypoints a block at the preset's
    shapes), 512-point patches, 420 anchor columns."""
    cuda.build_all()
    rs = np.random.RandomState(K)
    g = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(card)
    _, KB, _, _ = geom_cuda.spt_plan(K, 320, 420, 10)
    assert K % KB
    planes = tuple(g(K, 512) * 0.4 for _ in range(3))
    R = torch.linalg.qr(g(K, 3, 3))[0].contiguous()
    args = (g(20, 3, 16), g(16), torch.relu(g(16)), torch.rand(512, device=card),
            planes, R, 3, 20, 7, 0.8 / 3, 10)
    got = geom_cuda.spt_pooled_cuda(*args)
    torch.testing.assert_close(got, geom_cuda.spt_pooled_plain(*args),
                               rtol=2e-5, atol=2e-5)


def _tiny_pair(cfg, card, n=900, extent=0.6):
    rs = np.random.RandomState(0)
    raw = rs.uniform(-extent, extent, (n, 3)).astype(np.float32)
    raw[:, 2] = 0.25 * np.sin(4 * raw[:, 0]) + 0.2 * np.cos(3 * raw[:, 1]) + 1.5
    from buffer_tpu_torch.data.preprocess import prepare_pair
    return prepare_pair(cfg, raw, raw + np.float32(0.02),
                        rs=np.random.RandomState(1), already_downsampled=True,
                        device=card)


def _kernel_vs_plain_path(cfg, inputs, card):
    model = BufferModel(cfg).to(card)
    draws = registration.make_draws(cfg, torch.Generator(card).manual_seed(0), card)
    cuda.reset_launches()
    res_k, int_k = registration.register_pair(model, inputs, draws,
                                              return_intermediates=True)
    counts = cuda.launch_counts()
    cuda.reset_launches()
    with sites.plain_versions():
        res_p, int_p = registration.register_pair(model, inputs, draws,
                                                  return_intermediates=True)
    assert max(cuda.launch_counts().values()) == 0
    assert torch.equal(int_k["kidx"], int_p["kidx"])
    assert int(res_k.num_mutual) == int(res_p.num_mutual)
    torch.testing.assert_close(res_k.pose, res_p.pose, rtol=1e-5, atol=1e-5)
    return counts


@pytest.mark.cuda
def test_register_pair_kernels_match_plain_path(card):
    """A tiny pair on the card through the kernels and through the plain
    versions (substituted at the kernels' call sites): identical keypoints
    and matches, the same pose to 1e-5."""
    cfg = tiny_cfg()
    counts = _kernel_vs_plain_path(cfg, _tiny_pair(cfg, card), card)
    for name in ("nearest", "fps", "ball_sample", "spt_pooled"):
        assert counts[name] > 0, counts


@pytest.mark.cuda
def test_register_pair_banded_kernels_match_plain_path(card):
    """The same at a plan where the band is live (level 0 has 32 grid rows
    against a 16-row window): the banded kernels run too."""
    c = tiny_cfg()
    cfg = c.replace(static=dataclasses.replace(
        c.static, points_l0=4096, points_l1=2048, points_l2=512,
        raw_points=4096, knn_band=512))
    counts = _kernel_vs_plain_path(cfg, _tiny_pair(cfg, card, 4000, 1.0), card)
    for name in ("bknn", "bnn1", "nearest", "fps", "ball_sample", "spt_pooled"):
        assert counts[name] > 0, counts


@pytest.mark.cuda
def test_register_pair_shipped_preset_kernels_match_plain_path(card):
    """The shipped 3DMatch preset (knn_band = 4096) at full width on one
    synthetic fragment pair: the kernel path equals the plain path."""
    cfg = threedmatch_cfg()
    counts = _kernel_vs_plain_path(cfg, surface_pair(cfg, 0, card)[0], card)
    assert counts["bknn"] == 4 and counts["bnn1"] == 1, counts
    for name in ("nearest", "fps", "ball_sample", "spt_pooled"):
        assert counts[name] == 1, counts


def _sorted_clouds(rs, B, n, n_valid, device):
    pts = np.zeros((B, n, 3), np.float32)
    for b in range(B):
        c = rs.uniform(-1, 1, (n_valid, 3)).astype(np.float32)
        c[:, 2] = 0.3 * np.sin(3 * c[:, 0])
        pts[b, :n_valid] = morton_sort(c)
    valid = np.zeros((B, n), bool)
    valid[:, :n_valid] = True
    return (torch.from_numpy(pts).to(device),
            torch.from_numpy(valid).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [None, 0.08])
def test_banded_kernels_match_plain(card, radius):
    """bknn and bnn1 bit-equal to their plain versions (indices, validity
    and distances, valid or not); fps_single equal to the batched kernel's
    first cloud and to the plain version."""
    cuda.build_all()
    rs = np.random.RandomState(6)
    sup, sv = _sorted_clouds(rs, 2, 12288, 11000, card)
    sv[1, 3000:3300] = False
    if radius is None:
        qry, qv = sup, sv
    else:
        qry, qv = _sorted_clouds(rs, 2, 4096, 3500, card)
    for k, wr in ((16, 64), (34, 64), (16, 16)):
        got = knn_cuda.banded_knn_cuda(qry, sup, sv, qv, k, radius, wr)
        want = knn_cuda.banded_knn_plain(qry, sup, sv, qv, k, radius, wr)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    for a, b in zip(knn_cuda.banded_nn1_cuda(qry, sup, sv, qv),
                    knn_cuda.banded_nn1_plain(qry, sup, sv, qv)):
        assert torch.equal(a, b)
    single = fps_cuda.fps_cuda_single(sup[1], sv[1], 300)
    assert torch.equal(single, fps_cuda.fps_cuda_batched(sup[1:], sv[1:], 300)[0])
    assert torch.equal(single, fps_cuda.fps_single_plain(sup[1], sv[1], 300))


def _equal(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("case,k,radius", [
    ("self duplicates", 16, None), ("self duplicates", 1, 0.05),
    ("ratio 3", 16, 0.1), ("ratio 3", 128, None),
    ("ratio 1/3", 16, 0.08), ("mirror ties", 128, 0.3)])
def test_bknn_kernel_matches_plain_at_model_cases(card, case, k, radius):
    """The banded kNN bit-equal to its plain version on the model tests'
    inputs (tests/test_torch_kernel_models.py: floored zero distances, ties
    across rows, invalid points in windows, ragged Q and S, valid-count
    ratios 3 and 1/3, starts clipped at both ends), 16- and 64-row windows,
    through the wrapper and with a ring of 2 chunks."""
    from test_torch_kernel_models import _bknn_case
    from buffer_tpu_torch.utils.plan_sweep import bknn_variant, poisoned
    cuda.build_all()
    qry, sup, sv, qv = (t.to(card) for t in
                        _bknn_case(case, np.random.RandomState(k)))
    for wr in (16, 64):
        args = (qry, sup, sv, qv, k, radius, wr)
        want = knn_cuda.banded_knn_plain(*args)
        assert _equal(knn_cuda.banded_knn_cuda(*args), want)
        got = poisoned(want)
        knn_cuda.bknn_launcher(*args, got[:2] + [got[2].view(torch.uint8)],
                               bknn_variant(2))()
        assert _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["3DMatch", "KITTI"])
def test_bknn_kernel_matches_plain_at_preset_calls(card, preset):
    """Every banded call shape of the preset's pyramid (4 on 3DMatch, 5 on
    KITTI) on seeded Morton-sorted surfaces with invalid points, one
    launch each."""
    from test_torch_kernel_models import _banded_calls
    from buffer_tpu_torch.config import kitti_cfg
    cfg = threedmatch_cfg() if preset == "3DMatch" else kitti_cfg()
    cuda.build_all()
    rs = np.random.RandomState(3)
    for B, Q, S, LW in _banded_calls(cfg):
        sup, sv = _sorted_clouds(rs, B, S, S - 700, card)
        sv[0, S // 4:S // 4 + 500] = False
        if Q == S:
            qry, qv = sup, sv
        else:
            qry, qv = _sorted_clouds(rs, B, Q, Q - 300, card)
        radius = None if Q == S == cfg.static.points_l0 else 0.1
        before = cuda.launch_counts()["bknn"]
        got = knn_cuda.banded_knn_cuda(qry, sup, sv, qv, 16, radius)
        assert cuda.launch_counts()["bknn"] == before + 1
        assert _equal(got, knn_cuda.banded_knn_plain(qry, sup, sv, qv, 16,
                                                     radius))


@pytest.mark.cuda
@pytest.mark.parametrize("case,B,N,Q,k", [
    ("distinct", 2, 4096, 37, 64), ("ties", 2, 4096, 37, 64),
    ("ties", 1, 2400, 20, 600), ("distinct", 2, 1536, 9, 6),
    ("distinct", 2, 65536, 1500, 512), ("ties", 2, 131072, 1500, 512),
    ("distinct", 2, 65536, 512, 512), ("distinct", 2, 65536, 777, 512)])
def test_ball_kernels_match_plain_at_model_and_preset_shapes(card, case, B, N,
                                                             Q, k):
    """Ball sampling, planes and points, bit-equal to the plain versions on
    the model tests' inputs (tied priorities, in-ball invalid points,
    segments with 0 and 1 in-ball points, two slices of segments), at the
    presets' inference shapes, the training shape and a ragged Q; through
    the wrappers and through the C launch with 4 and 8 queries a thread
    and slices of 32 and 256 segments."""
    from test_torch_kernel_models import _ball_inputs
    from buffer_tpu_torch.utils.plan_sweep import ball_variant, poisoned
    cuda.build_all()
    args = _ball_inputs(case, np.random.RandomState(Q), B, N, Q, k, 0.3)
    args = tuple(t.to(card) for t in args[:4]) + args[4:]
    NS = k // 2
    want = geom_cuda.ball_sample_planes_plain(*args)
    assert _equal(geom_cuda.ball_sample_planes_cuda(*args), want)
    pts, v = geom_cuda.ball_sample_points_cuda(*args)
    assert torch.equal(pts, torch.stack(want[:3], -1))
    assert torch.equal(v, want[3])
    for qt in geom_cuda.BALL_QUERIES:
        for nsb in (32, 256):
            plan = ball_variant(NS, qt, nsb, geom_cuda.BALL_RING)
            got = poisoned(want)
            geom_cuda.ball_launcher(geom_cuda.BALL, *args,
                                    got[:3] + [got[3].view(torch.uint8)],
                                    plan)()
            assert _equal(got, want)
            pts, v = poisoned([torch.stack(want[:3], -1), want[3]])
            geom_cuda.ball_launcher(geom_cuda.BALL_POINTS, *args,
                                    [pts, v.view(torch.uint8)], plan)()
            assert torch.equal(pts, torch.stack(want[:3], -1))
            assert torch.equal(v, want[3])


@pytest.mark.cuda
def test_bknn_and_ball_bad_plans_raise(card):
    """A plan the launchers do not take raises (no fallback)."""
    cuda.build_all()
    sup, sv = _sorted_clouds(np.random.RandomState(0), 1, 4096, 4000, card)
    d = torch.empty((1, 4096, 16), device=card)
    i = torch.empty((1, 4096, 16), dtype=torch.int32, device=card)
    v = torch.empty((1, 4096, 16), dtype=torch.uint8, device=card)
    with pytest.raises(RuntimeError):
        knn_cuda.bknn_launcher(sup, sup, sv, sv, 16, None, 16, [d, i, v],
                               (512, 4, knn_cuda.bknn_smem_bytes(4)))()
    prio = torch.rand((1, 4096), device=card)
    outs = [torch.empty((1, 10, 64), device=card) for _ in range(3)]
    outs.append(torch.empty((1, 10, 64), dtype=torch.uint8, device=card))
    with pytest.raises(RuntimeError):
        geom_cuda.ball_launcher(geom_cuda.BALL, sup[:, :10], sup, sv, prio,
                                0.3, 64, outs, (12, 8, 32, 16, 3, 30744))()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["self duplicates", "ratio 3", "ratio 1/3",
                                  "mirror ties", "truncation ties",
                                  "all invalid"])
def test_bnn1_kernel_matches_plain_at_model_cases(card, case):
    """The banded 1-NN bit-equal to its plain version on the model tests'
    inputs (tests/test_torch_kernel_models.py: floored zero distances, ties
    across rows and at 16-bit truncation, an all-invalid support and no
    valid queries, ratios 3 and 1/3 with starts clipped at both ends,
    ragged Q), through the wrapper and through the C launch at 4, 8 and 16
    queries a thread."""
    from test_torch_kernel_models import _bnn1_case
    from buffer_tpu_torch.utils.plan_sweep import BNN1_ALTERNATIVES, poisoned
    cuda.build_all()
    args = tuple(t.to(card) for t in
                 _bnn1_case(case, np.random.RandomState(sum(map(ord, case)))))
    want = knn_cuda.banded_nn1_plain(*args)
    assert _equal(knn_cuda.banded_nn1_cuda(*args), want)
    for plan in BNN1_ALTERNATIVES:
        got = poisoned(want)
        knn_cuda.bnn1_launcher(*args, got, plan)()
        assert _equal(got, want), plan


@pytest.mark.cuda
@pytest.mark.parametrize("B,Q,S", [(2, 30720, 10240), (2, 40960, 20480),
                                   (1, 30720, 30720)])
def test_bnn1_kernel_matches_plain_at_preset_calls(card, B, Q, S):
    """The banded 1-NN's calls: 3DMatch's and KITTI's l0 -> l1 upsample and
    the training sampler (B = 1), on seeded Morton-sorted surfaces with
    invalid points, one launch each."""
    cuda.build_all()
    rs = np.random.RandomState(Q + S)
    sup, sv = _sorted_clouds(rs, B, S, S - 700, card)
    sv[0, S // 4:S // 4 + 500] = False
    qry, qv = _sorted_clouds(rs, B, Q, Q - 300, card)
    before = cuda.launch_counts()["bnn1"]
    got = knn_cuda.banded_nn1_cuda(qry, sup, sv, qv)
    assert cuda.launch_counts()["bnn1"] == before + 1
    assert _equal(got, knn_cuda.banded_nn1_plain(qry, sup, sv, qv))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["duplicates", "mirror ties", "all invalid",
                                  "tiny"])
def test_nearest_kernel_matches_plain_at_model_cases(card, case):
    """The exact 1-NN bit-equal to its plain version on the model tests'
    inputs (duplicates and mirror ties to the lowest index, an all-invalid
    support, ragged Q and S), through the wrapper and through the C launch
    at every plan of the sweep."""
    from test_torch_kernel_models import _nearest_case
    from buffer_tpu_torch.utils.plan_sweep import NEAREST_ALTERNATIVES, poisoned
    cuda.build_all()
    args = tuple(t.to(card) for t in
                 _nearest_case(case, np.random.RandomState(sum(map(ord, case)))))
    want = geom_cuda.nearest_plain(*args)
    assert _equal(geom_cuda.nearest_cuda(*args), want)
    for plan in NEAREST_ALTERNATIVES:
        got = poisoned(want)
        geom_cuda.nearest_launcher(*args, got, plan)()
        assert _equal(got, want), plan


@pytest.mark.cuda
@pytest.mark.parametrize("B,Q,S", [(2, 10240, 3072), (2, 20480, 6144),
                                   (2, 30720, 10240), (1, 30720, 30720)])
def test_nearest_kernel_matches_plain_at_preset_calls(card, B, Q, S):
    """The exact 1-NN's calls: both presets' l1 -> l2 upsample, and at
    knn_band = 0 the l0 -> l1 upsample and the training sampler (B = 1),
    with invalid support points, one launch each."""
    cuda.build_all()
    rs = np.random.RandomState(Q + S)
    sup, sv = _sorted_clouds(rs, B, S, S - 200, card)
    sv[0, S // 3:S // 3 + 100] = False
    qry, _ = _sorted_clouds(rs, B, Q, Q, card)
    before = cuda.launch_counts()["nearest"]
    got = geom_cuda.nearest_cuda(qry, sup, sv)
    assert cuda.launch_counts()["nearest"] == before + 1
    assert _equal(got, geom_cuda.nearest_plain(qry, sup, sv))


@pytest.mark.cuda
def test_bnn1_and_nearest_bad_plans_raise(card):
    """A plan the launchers do not take raises (no fallback): 2 or 32
    queries a thread for the banded 1-NN, 3 queries a thread or a cluster
    of 16 for the exact one."""
    cuda.build_all()
    sup, sv = _sorted_clouds(np.random.RandomState(0), 1, 4096, 4000, card)
    outs = [torch.empty((1, 4096), device=card),
            torch.empty((1, 4096), dtype=torch.int32, device=card)]
    for plan in (2, 32):
        with pytest.raises(RuntimeError):
            knn_cuda.bnn1_launcher(sup, sup, sv, sv, outs, plan)()
    for plan in ((3, 2), (4, 16)):
        with pytest.raises(RuntimeError):
            geom_cuda.nearest_launcher(sup, sup, sv, outs, plan)()


@pytest.mark.cuda
def test_test_entry_point_on_card(card, tmp_path):
    """``python -m buffer_tpu_torch.scripts.test`` on the card (the default
    device) at the tiny plan, over a small 3DMatch tree written here:
    every pair launches the tiny plan's kernels (its neighbour searches
    take the exact routes) and est.log holds a pose a pair."""
    from buffer_tpu_torch.data.ply import write_ply_points
    from buffer_tpu_torch.data.synthetic import wavy_surface
    from buffer_tpu_torch.eval import metrics
    from buffer_tpu_torch.scripts import test as entry
    from buffer_tpu_torch.train import checkpoint
    cuda.build_all()
    rs = np.random.RandomState(3)
    world = wavy_surface(rs, 40000, 1.2)
    root, scene = tmp_path / "tree", "wavy"
    fdir = root / "test" / "3DMatch" / "fragments" / scene
    gdir = root / "test" / "3DMatch" / "gt_result" / scene
    fdir.mkdir(parents=True)
    gdir.mkdir(parents=True)
    for i, lo in enumerate((-1.2, -0.6, 0.0)):
        frag = world[(world[:, 0] >= lo) & (world[:, 0] <= lo + 1.2)]
        write_ply_points(str(fdir / f"cloud_bin_{i}.ply"), frag)
    pairs = [(0, 1), (0, 2)]
    with open(gdir / "gt.log", "w") as f, open(gdir / "gt.info", "w") as g:
        for i, j in pairs:
            f.write(f"{i}\t{j}\t3\n" + "1 0 0 0\n0 1 0 0\n0 0 1 0\n0 0 0 1\n")
            g.write(f"{i}\t{j}\t3\n" + "".join(
                " ".join("100" if r == c else "0" for c in range(6)) + "\n"
                for r in range(6)))
    model = BufferModel(tiny_cfg(), seed=2)
    for s in ("Ref", "Desc", "Keypt", "Inlier"):
        checkpoint.save(model, str(tmp_path / "w" / s / "best.pth"))
    cuda.reset_launches()
    out = entry.main(["--config", "3DMatch", "--tiny", "--data-root",
                      str(root), "--weights", str(tmp_path / "w"),
                      "--log-dir", str(tmp_path / "log")])
    assert out["pairs"] == 2 and 0.0 <= out["registration_recall"] <= 1.0
    launches = {k: v for k, v in cuda.launch_counts().items() if v}
    # the tiny plan's pair_unroll = 3: one group of the 2 pairs and the
    # second again (padding, its result discarded), 3 pairs' launches
    assert launches == {"nearest": 6, "fps": 3, "ball_sample": 3,
                        "spt_pooled": 3}
    _, traj = metrics.read_trajectory(str(tmp_path / "log" / scene / "est.log"))
    assert traj.shape == (2, 4, 4) and np.isfinite(traj).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,voxel,out_size", [(30720, 0.07, 10240),
                                              (40000, 0.02, 3000)])
def test_voxel_subsample_on_card_equals_cpu(card, n, voxel, out_size):
    """The device voxel subsampling on the card bit for bit as on the CPU
    (the sums run in sorted order, one thread a segment; the divisions take
    a device tensor), with padding rows and, in the second case, an
    overflowing ``out_size``."""
    from buffer_tpu_torch.ops.subsample import voxel_subsample
    rs = np.random.RandomState(9)
    pts = torch.from_numpy(rs.uniform(-1.5, 2.5, (n, 3)).astype(np.float32))
    valid = torch.from_numpy(rs.rand(n) > 0.2)
    want = voxel_subsample(pts, valid, voxel, out_size)
    got = voxel_subsample(pts.to(card), valid.to(card), voxel, out_size)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_device_levels_on_card_equal_host_levels(card):
    """``device_levels`` of the full-width 3DMatch pair on the card: the
    host-built levels (``prepare_pair``) as point sets within 1e-5 with
    equal valid counts, and bit for bit the CPU's device levels."""
    from buffer_tpu_torch.pipeline.pyramid import device_levels
    cfg = threedmatch_cfg()
    pair, _ = surface_pair(cfg, 0, "cpu")
    got = device_levels(cfg, pair.sds.to(card), pair.sds_mask.to(card))
    want = device_levels(cfg, pair.sds, pair.sds_mask)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    host = (pair.lvl1, pair.lvl1_mask, pair.lvl2, pair.lvl2_mask)
    for lvl in (0, 2):
        for b in range(2):
            a = got[lvl][b][got[lvl + 1][b]].cpu()
            h = host[lvl][b][host[lvl + 1][b]]
            assert len(a) == len(h) > 0
            d = torch.cdist(a.double(), h.double())
            assert float(d.min(1).values.max()) < 1e-5
            assert float(d.min(0).values.max()) < 1e-5


def _cpu(nt):
    return type(nt)(*(None if t is None else t.cpu() for t in nt))


@pytest.mark.cuda
def test_dp_register_world_2_on_card_equals_one_process(card):
    """``make_dp_register`` at world 2, both ranks on the card (gloo), over
    3 tiny banded pairs (the second round padded): on both ranks the
    gathered poses and mutual counts equal one process's ``register_pair``
    bit for bit, and every pair launches the kernels."""
    from buffer_tpu_torch.utils import dp_scaling
    c = tiny_cfg()
    cfg = c.replace(static=dataclasses.replace(
        c.static, points_l0=4096, points_l1=2048, points_l2=512,
        raw_points=4096, knn_band=512))
    model = BufferModel(cfg, seed=1).to(card).eval()
    pairs = [_cpu(_tiny_pair(cfg, card, 4000, 1.0 + 0.1 * i)) for i in range(3)]
    gen = torch.Generator(card).manual_seed(0)
    draws = [registration.make_draws(cfg, gen, card) for _ in pairs]
    out = dp_scaling.measure(cfg, model.state_dict(), pairs, draws, 2, "gloo",
                             iters=0, timeout=300)
    for i, (p, d) in enumerate(zip(pairs, draws)):
        res = registration.register_pair(model, p, d, device=card)
        for o in out:
            assert torch.equal(o["pose"][i], res.pose.cpu())
            assert int(o["num_mutual"][i]) == int(res.num_mutual)
    for o in out:
        for rose in o["launches"]:
            for name in ("bknn", "bnn1", "nearest", "fps", "ball_sample",
                         "spt_pooled"):
                assert rose[name] > 0, rose


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["Ref", "Desc"])
def test_dp_train_step_world_2_on_card(card, stage):
    """The DP step of ``stage`` at world 2 on the card (gloo), tiny banded
    plan, two pairs, under deterministic algorithms: parameters bit-equal
    across ranks, and equal to one process's step on the mean gradient
    within 1e-5 (loss) / 1e-6 (parameters)."""
    import os
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.train.trainer import (TrainBatch, make_optimizer,
                                                mean_train_step)
    from buffer_tpu_torch.utils.dist import launch
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    c = tiny_cfg()
    cfg = c.replace(static=dataclasses.replace(
        c.static, points_l0=4096, points_l1=2048, points_l2=512,
        raw_points=4096, knn_band=512))
    model = BufferModel(cfg, seed=1)
    state = model.state_dict()
    T = torch.eye(4)
    T[:3, 3] = 0.02
    batches = [TrainBatch(_cpu(_tiny_pair(cfg, card, 4000, 1.0 + 0.1 * i)), T)
               for i in range(2)]
    gen = torch.Generator(card).manual_seed(3)
    draws = [_cpu(make_train_draws(cfg, gen, card)) for _ in batches]
    out = launch("buffer_tpu_torch.utils.dp_jobs:train_job",
                 {"cfg": cfg, "state": state, "stages": [stage],
                  "batches": [batches], "draws": {stage: [draws]},
                  "device": None, "deterministic": True}, 2, backend="gloo",
                 timeout=300)
    got = [o["stages"][stage]["steps"][0] for o in out]
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        model = model.to(card)
        opt, _ = make_optimizer(cfg, model, stage)
        loss, _ = mean_train_step(model, opt, stage, batches, draws,
                                  device=card)
    finally:
        torch.use_deterministic_algorithms(False)
    assert abs(float(got[0]["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
    ref = model.state_dict()
    for k, v in got[0]["state"].items():
        torch.testing.assert_close(v, ref[k].cpu(), rtol=0, atol=1e-6, msg=k)


def _program_pairs(plan, card):
    """(config with the low-match budget on, two pairs) of ``plan``."""
    if plan == "tiny":
        cfg = tiny_cfg()
        pairs = [_tiny_pair(cfg, card), _tiny_pair(cfg, card, 800, 0.5)]
    else:
        cfg = threedmatch_cfg()
        pairs = [surface_pair(cfg, s, card)[0] for s in (0, 1)]
    cfg = cfg.replace(static=dataclasses.replace(cfg.static,
                                                 low_match_boost=True))
    return cfg, pairs


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["tiny", "3DMatch"])
@pytest.mark.parametrize("th", [0, 10 ** 6])
def test_program_equals_register_pair(card, plan, th):
    """``make_register_fn`` on the card: the first call (warm-up, capture)
    and the replays over two pairs bit-equal to ``register_pair`` on the
    same inputs and draws, with every pair on the base tail
    (``low_match_th = 0``) or on the boost tail (above any mutual count);
    a result keeps its values through the calls after it; a replay's
    launch counts are the eager pair's."""
    cuda.build_all()
    cfg, pairs = _program_pairs(plan, card)
    cfg = cfg.replace(static=dataclasses.replace(cfg.static, low_match_th=th))
    model = BufferModel(cfg, seed=0).to(card)
    gen = torch.Generator(card).manual_seed(0)
    draws = [registration.make_draws(cfg, gen, card) for _ in pairs]
    cuda.reset_launches()
    want = [registration.register_pair(model, p, d) for p, d in zip(pairs, draws)]
    eager = cuda.launch_counts()
    fn = registration.make_register_fn(model)
    got = []
    for _ in range(2):
        for p, d, w in zip(pairs, draws, want):
            cuda.reset_launches()
            got.append((fn(p, d), w))
            assert cuda.launch_counts() == {k: v // 2 for k, v in eager.items()}
            assert all(torch.equal(a, b) for a, b in zip(*got[-1]))
            assert registration.boost_taken(cfg, got[-1][0].num_mutual) == (th > 0)
    for res, w in got:
        assert all(torch.equal(a, b) for a, b in zip(res, w))
    (program,) = fn.programs.values()
    assert sorted(program.tails) == [False, True]


def _sync_count(fn):
    """``fn()`` and the number of host synchronizations it made (CUDA's
    sync debug mode warns on each)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["tiny", "3DMatch"])
def test_unrolled_program_equals_register_fn(card, plan):
    """``make_unrolled_register_fn`` on the card at U = 3 over three pairs,
    with ``low_match_th`` between two pairs' mutual counts: the first call
    (warm-up, capture) and two replays return, pair by pair, what
    ``make_register_fn`` returns on the same inputs and draws, bit for bit;
    the group takes both tails; a call launches three pairs' kernels and
    makes one host read; every chain has its own stream and memory pool;
    a result keeps its values through the calls after it."""
    cuda.build_all()
    cfg, pairs = _program_pairs(plan, card)
    if plan == "tiny":
        pairs.append(_tiny_pair(cfg, card, 700, 0.4))
    else:
        pairs.append(surface_pair(cfg, 2, card)[0])
    gen = torch.Generator(card).manual_seed(0)
    draws = [registration.make_draws(cfg, gen, card) for _ in pairs]
    counts = [int(registration.register_pair(
        BufferModel(cfg, seed=0).to(card), p, d).num_mutual)
        for p, d in zip(pairs, draws)]
    assert min(counts) < max(counts), counts
    cfg = cfg.replace(static=dataclasses.replace(cfg.static,
                                                 low_match_th=max(counts)))
    model = BufferModel(cfg, seed=0).to(card)
    single = registration.make_register_fn(model)
    cuda.reset_launches()
    want = [single(p, d) for p, d in zip(pairs, draws)]
    want = [single(p, d) for p, d in zip(pairs, draws)]    # replays
    per_pair = {k: v // 6 for k, v in cuda.launch_counts().items()}
    fn = registration.make_unrolled_register_fn(model, 3)
    got = []
    for n_call in range(3):
        cuda.reset_launches()
        res, syncs = _sync_count(lambda: fn(pairs, draws))
        got.append(res)
        assert cuda.launch_counts() == {k: 3 * v for k, v in per_pair.items()}
        if n_call:
            assert syncs == 1
        for u, w in enumerate(want):
            assert all(torch.equal(a[u], b) for a, b in zip(res, w)), u
    assert {registration.boost_taken(cfg, n)
            for n in got[-1].num_mutual} == {False, True}
    for res in got:
        for u, w in enumerate(want):
            assert all(torch.equal(a[u], b) for a, b in zip(res, w))
    (program,) = fn.programs.values()
    chains = program.chains
    assert len({c.stream.cuda_stream for c in chains}) == 3
    assert len({c.pool for c in chains}) == 3
    assert all(sorted(c.tails) == [False, True] for c in chains)


@pytest.mark.cuda
def test_program_intermediates_equal_register_pair(card):
    """With ``return_intermediates`` a replay returns ``register_pair``'s
    intermediates dict bit for bit, as copies of its own."""
    cfg, (pair, _) = _program_pairs("tiny", card)
    model = BufferModel(cfg, seed=0).to(card)
    draws = registration.make_draws(cfg, torch.Generator(card).manual_seed(1),
                                    card)
    fn = registration.make_register_fn(model, return_intermediates=True)
    fn(pair, draws)
    res, inter = fn(pair, draws)
    want_res, want = registration.register_pair(model, pair, draws,
                                                 return_intermediates=True)
    assert all(torch.equal(a, b) for a, b in zip(res, want_res))
    leaves = torch.utils._pytree.tree_leaves
    for name in want:
        assert all(torch.equal(a, b) for a, b in
                   zip(leaves(inter[name]), leaves(want[name]))), name
    again, _ = fn(pair, draws)
    assert again.pose.data_ptr() != res.pose.data_ptr()


@pytest.mark.cuda
def test_program_raises_on_swapped_parameters(card):
    """Weights loaded in place carry over into the replays; a replaced
    parameter tensor makes the next call raise (no silent stale graph)."""
    cfg, (pair, _) = _program_pairs("tiny", card)
    model = BufferModel(cfg, seed=0).to(card)
    draws = registration.make_draws(cfg, torch.Generator(card).manual_seed(2),
                                    card)
    fn = registration.make_register_fn(model)
    fn(pair, draws)
    model.load_state_dict(BufferModel(cfg, seed=5).state_dict())
    want = registration.register_pair(model, pair, draws)
    assert all(torch.equal(a, b) for a, b in zip(fn(pair, draws), want))
    conv = model.Desc.pnt_layer[0]
    conv.weight = torch.nn.Parameter(conv.weight.detach().clone())
    with pytest.raises(RuntimeError, match="captured"):
        fn(pair, draws)


def _train_setup(card, n_pairs=2):
    """The tiny plan, a seeded model on the card and ``n_pairs`` training
    batches (the wavy surface shifted by 2 cm, its pose)."""
    from buffer_tpu_torch.train.trainer import TrainBatch
    cfg = tiny_cfg()
    T = torch.eye(4, device=card)
    T[:3, 3] = 0.02
    batches = [TrainBatch(_tiny_pair(cfg, card, 900 - 100 * i, 0.6 - 0.05 * i), T)
               for i in range(n_pairs)]
    return cfg, BufferModel(cfg, seed=0).to(card), batches


def _step_state(model, optimizer):
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"]):
        sd.update({f"adam.{i}.{k}": v.clone()
                   for k, v in optimizer.state[p].items()})
    return sd


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["Ref", "Desc", "Keypt", "Inlier"])
def test_train_program_equals_eager_steps(card, stage, tmp_path):
    """``Trainer.step`` (a CUDA graph after its first call) against
    ``train_step`` on a twin model and Adam, under deterministic
    algorithms, four steps: the first call, a replay, a replay after
    ``set_epoch_lr`` moved the rate, a replay with a NaN pose: loss, stats,
    every parameter and buffer and Adam's state bit for bit (NaN equal to
    NaN) after each, and each replay launching what the eager step
    launches."""
    import copy
    import os
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.train import trainer as tr
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cuda.build_all()
    cfg, model, batches = _train_setup(card)
    twin = copy.deepcopy(model)
    bad = tr.TrainBatch(batches[0].inputs, torch.full_like(batches[0].relt_pose,
                                                           float("nan")))
    gen = torch.Generator(card).manual_seed(0)
    interval = cfg.optim.scheduler_interval[stage]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        trainer = tr.Trainer(cfg, model, stage, str(tmp_path), device=card)
        opt, lr_for_epoch = tr.make_optimizer(cfg, twin, stage)
        for i, (batch, epoch) in enumerate([(batches[0], 0), (batches[1], 0),
                                            (batches[0], interval),
                                            (bad, interval)]):
            trainer.set_epoch_lr(epoch)
            tr.set_lr(opt, lr_for_epoch(epoch))
            draws = make_train_draws(cfg, gen, card)
            cuda.reset_launches()
            loss, stats = trainer.step(batch, draws)
            rose = cuda.launch_counts()
            cuda.reset_launches()
            loss_e, stats_e = tr.train_step(twin, opt, stage, batch, draws,
                                            trainer.det_margin, card)
            assert cuda.launch_counts() == rose
            _same(loss, loss_e)
            assert stats.keys() == stats_e.keys()
            for k in stats:
                _same(stats[k], stats_e[k])
            a, b = _step_state(model, trainer.optimizer), _step_state(twin, opt)
            for k in a:
                _same(a[k], b[k])
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(trainer.train_fn.programs) == 1


@pytest.mark.cuda
def test_train_program_skips_a_data_borne_nan(card, tmp_path):
    """A replay of the Ref step with a NaN ground-truth pose (its gradient
    not finite): ``grad_finite`` 0, the parameters and Adam's state as
    before the step, the running statistics moved."""
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.train import trainer as tr
    cuda.build_all()
    cfg, model, batches = _train_setup(card, 1)
    trainer = tr.Trainer(cfg, model, "Ref", str(tmp_path), device=card)
    gen = torch.Generator(card).manual_seed(1)
    for _ in range(2):
        trainer.step(batches[0], make_train_draws(cfg, gen, card))
    before = _step_state(model, trainer.optimizer)
    bad = tr.TrainBatch(batches[0].inputs, torch.full_like(batches[0].relt_pose,
                                                           float("nan")))
    _, stats = trainer.step(bad, make_train_draws(cfg, gen, card))
    after = _step_state(model, trainer.optimizer)
    assert float(stats["grad_finite"]) == 0.0
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    assert moved and all("running" in k or "num_batches" in k for k in moved)


@pytest.mark.cuda
def test_eval_program_equals_eval_step(card, tmp_path):
    """``Trainer.evaluate``'s compiled step: the first call and a replay
    equal ``eval_step`` bit for bit for every stage, and move nothing."""
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.train import trainer as tr
    cuda.build_all()
    cfg, model, batches = _train_setup(card, 1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    draws = make_train_draws(cfg, torch.Generator(card).manual_seed(2), card)
    for stage in ("Ref", "Desc", "Keypt", "Inlier"):
        fn = tr.make_eval_step(model, stage, 1.05)
        want = tr.eval_step(model, stage, batches[0], draws, 1.05, card)
        for _ in range(2):
            loss, stats = fn(batches[0], draws)
            _same(loss, want[0])
            for k in want[1]:
                _same(stats[k], want[1][k])
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.cuda
def test_train_program_raises_on_a_replaced_parameter(card, tmp_path):
    """A parameter replaced after capture makes the next call raise (no
    silent stale graph); weights loaded in place replay."""
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.train import trainer as tr
    cuda.build_all()
    cfg, model, batches = _train_setup(card, 1)
    trainer = tr.Trainer(cfg, model, "Desc", str(tmp_path), device=card)
    gen = torch.Generator(card).manual_seed(3)
    trainer.step(batches[0], make_train_draws(cfg, gen, card))
    model.load_state_dict(BufferModel(cfg, seed=5).state_dict())
    trainer.step(batches[0], make_train_draws(cfg, gen, card))
    conv = model.Desc.pnt_layer[0]
    conv.weight = torch.nn.Parameter(conv.weight.detach().clone())
    with pytest.raises(RuntimeError, match="captured"):
        trainer.step(batches[0], make_train_draws(cfg, gen, card))


@pytest.mark.cuda
def test_dp_train_program_world_2_equals_eager_dp_step(card):
    """The DP program (two CUDA graphs around the eager all-reduce) at
    world 2 on the card over gloo, tiny banded plan, Ref then Desc, three
    steps each under deterministic algorithms: every step bit-equal on
    every rank to the eager DP step from the same state (loss, stats, the
    stage's state, Adam's state), and the ranks equal."""
    import os
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.train.trainer import TrainBatch
    from buffer_tpu_torch.utils.dist import launch
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    c = tiny_cfg()
    cfg = c.replace(static=dataclasses.replace(
        c.static, points_l0=4096, points_l1=2048, points_l2=512,
        raw_points=4096, knn_band=512))
    T = torch.eye(4)
    T[:3, 3] = 0.02
    batches = [TrainBatch(_cpu(_tiny_pair(cfg, card, 4000, 1.0 + 0.1 * i)), T)
               for i in range(2)]
    gen = torch.Generator(card).manual_seed(3)
    stages = ["Ref", "Desc"]
    draws = {s: [[_cpu(make_train_draws(cfg, gen, card)) for _ in batches]
                 for _ in range(3)] for s in stages}
    out = launch("buffer_tpu_torch.utils.dp_jobs:train_job",
                 {"cfg": cfg, "state": BufferModel(cfg, seed=1).state_dict(),
                  "stages": stages, "batches": [batches] * 3, "draws": draws,
                  "device": None, "deterministic": True, "eager": True},
                 2, backend="gloo", timeout=300)
    for stage in stages:
        for o in out:
            for st in o["stages"][stage]["steps"]:
                e = st["eager"]
                _same(st["loss"], e["loss"])
                for k, v in st["stats"].items():
                    _same(v, e["stats"][k])
                for k, v in st["state"].items():
                    _same(v, e["state"][k])
                for a, b in zip(st["adam"], e["adam"]):
                    for k in a:
                        _same(a[k], b[k])
        last = [o["stages"][stage]["steps"][-1]["state"] for o in out]
        for k, v in last[0].items():
            _same(v, last[1][k])
