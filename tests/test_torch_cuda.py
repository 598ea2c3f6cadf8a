"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and skip without one (a CUDA kernel has no
CPU mode).  The file imports neither JAX nor the JAX package, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses
import statistics
import time

import numpy as np
import pytest
import torch

from buffer_tpu_torch.config import kitti_cfg, threedmatch_cfg, tiny_cfg
from buffer_tpu_torch.core import graphs, se3
from buffer_tpu_torch.data.preprocess import morton_sort
from buffer_tpu_torch.data.synthetic import surface_pair
from buffer_tpu_torch.kernels import (conv_cuda, cuda, cyl_cuda, fps_cuda,
                                      geom_cuda, knn_cuda, pose_cuda, sites)
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.pipeline import registration
from buffer_tpu_torch.utils import profiling


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
    """The pair through the kernels and through the plain versions, the
    convolutions kept on their kernel (``sites.CONVOLUTIONS``: they sum in
    another order than cuDNN, so the matches after them are compared with
    the kernel kept, and each convolution is held to a float64 one by
    ``test_conv_kernel_matches_float64_at_layer_shapes``)."""
    model = BufferModel(cfg).to(card)
    draws = registration.make_draws(cfg, torch.Generator(card).manual_seed(0), card)
    cuda.reset_launches()
    res_k, int_k = registration.register_pair(model, inputs, draws,
                                              return_intermediates=True)
    counts = cuda.launch_counts()
    cuda.reset_launches()
    with sites.plain_versions(keep=sites.CONVOLUTIONS):
        res_p, int_p = registration.register_pair(model, inputs, draws,
                                                  return_intermediates=True)
    assert {k for k, v in cuda.launch_counts().items() if v} <= {"conv"}
    assert torch.equal(int_k["kidx"], int_p["kidx"])
    assert int(res_k.num_mutual) == int(res_p.num_mutual)
    torch.testing.assert_close(res_k.pose, res_p.pose, rtol=1e-5, atol=1e-5)
    return counts


@pytest.mark.cuda
def test_register_pair_kernels_match_plain_path(card):
    """A tiny pair on the card through the kernels and through the plain
    versions (substituted at the kernels' call sites, the convolutions'
    kept): identical keypoints and matches, the same pose to 1e-5."""
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
    paths = conv_cuda.path_launches()
    counts = _kernel_vs_plain_path(cfg, surface_pair(cfg, 0, card)[0], card)
    paths = {k: v - paths[k] for k, v in conv_cuda.path_launches().items()}
    # the kernel path's pair and the plain path's (the convolutions kept)
    assert paths == {"halo": 2 * 13, "tap": 2 * 5}, paths
    assert counts["bknn"] == 4 and counts["bnn1"] == 1, counts
    for name in ("nearest", "fps", "ball_sample", "spt_pooled", "cost_volume"):
        assert counts[name] == 1, counts
    assert counts["cyl_pad"] == 1 and counts["conv"] == 18, counts


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


def _rigid_set(rs, bs, n, noise, outliers=0):
    """bs sets of n source points, their targets under one rotation and
    translation with Gaussian noise, the last ``outliers`` of each moved
    1-3 m away: (src, tgt) float32 arrays."""
    q, _ = np.linalg.qr(rs.randn(3, 3))
    q[:, 0] *= np.sign(np.linalg.det(q))
    src = rs.uniform(-1.0, 1.0, (bs, n, 3))
    tgt = src @ q.T + np.array([0.3, -0.2, 0.5]) + noise * rs.randn(bs, n, 3)
    if outliers:
        away = rs.randn(bs, outliers, 3)
        away *= rs.uniform(1.0, 3.0, (bs, outliers, 1)) / np.linalg.norm(
            away, axis=-1, keepdims=True)
        tgt[:, n - outliers:] += away
    return src.astype(np.float32), tgt.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hypotheses", "refit", "zero weights",
                                  "two weights"])
def test_kabsch_kernel_matches_plain(card, case):
    """The batched Kabsch against ``se3.kabsch_quat`` on the card, pose
    within 1e-5: RANSAC's 4096 unweighted 3-point hypotheses (one thread a
    problem), the refit over 1500 weighted points (one CTA), all-zero
    weights and fewer than 3 nonzero weights (the degenerate solves both
    versions still make)."""
    cuda.build_all()
    rs = np.random.RandomState(11)
    bs, n = (4096, 3) if case == "hypotheses" else (1, 1500)
    src, tgt = _rigid_set(rs, bs, n, 0.005)
    A, B = (torch.from_numpy(x).to(card) for x in (src, tgt))
    w = None
    if case != "hypotheses":
        w = torch.from_numpy(rs.uniform(0.2, 1.0, (bs, n)).astype(np.float32))
        w = w.to(card)
        if case == "zero weights":
            w.zero_()
        elif case == "two weights":
            w[:, 2:] = 0
    before = cuda.launch_counts()["kabsch"]
    got = pose_cuda.kabsch_cuda(A, B, w)
    assert cuda.launch_counts()["kabsch"] == before + 1
    want = se3.kabsch_quat(A, B, w)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got[:, 3], want[:, 3])


def _irls_inputs(card, case):
    """(pose, src, tgt, valid, th) of an IRLS call: 1500 correspondences,
    300 of them outliers, 100 more invalid, from a pose half a degree and
    5 mm off (every inlier well inside the threshold from the first round); "two valid" keeps 2 valid inliers, so every round keeps the pose,
    "three valid" 3, the fewest that a round solves on."""
    rs = np.random.RandomState(5)
    src, tgt = (x[0] for x in _rigid_set(rs, 1, 1500, 0.003, outliers=300))
    valid = np.ones(1500, bool)
    valid[:100] = False
    if case != "full":
        valid[:] = False
        valid[100:102 if case == "two valid" else 103] = True
    c, s = np.cos(np.radians(0.5)), np.sin(np.radians(0.5))
    tweak = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    est = np.linalg.lstsq(np.c_[src[100:1200], np.ones(1100)], tgt[100:1200],
                          rcond=None)[0].T
    pose = np.eye(4)
    pose[:3, :3] = tweak @ est[:, :3]
    pose[:3, 3] = est[:, 3] + 0.005
    to = lambda x: torch.from_numpy(np.asarray(x)).to(card)
    return (to(pose.astype(np.float32)), to(src), to(tgt), to(valid), 0.10)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [10, 20])
@pytest.mark.parametrize("case", ["full", "two valid", "three valid"])
def test_irls_kernel_matches_plain(card, iters, case):
    """Every IRLS round in one launch against the plain loop on the card:
    pose within 1e-5 and the same inliers under it; with 2 valid inliers
    every round keeps the starting pose, bit for bit."""
    cuda.build_all()
    pose, src, tgt, valid, th = _irls_inputs(card, case)
    before = cuda.launch_counts()["irls"]
    got = pose_cuda.irls_cuda(pose, src, tgt, valid, th, iters)
    assert cuda.launch_counts()["irls"] == before + 1
    want = pose_cuda.irls_plain(pose, src, tgt, valid, th, iters)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)

    def inliers(T):
        d = torch.linalg.norm(src @ T[:3, :3].T + T[:3, 3] - tgt, dim=-1)
        return (d < th) & valid
    assert torch.equal(inliers(got), inliers(want))
    if case == "two valid":
        assert torch.equal(got, pose)
    else:
        assert not torch.equal(got, pose)
        assert int(inliers(got).sum()) == (1100 if case == "full" else 3)


@pytest.mark.cuda
def test_pose_wrappers_raise(card):
    """A CUDA tensor the kernels do not take raises (no fallback): not
    contiguous, on two devices, or asking for a gradient."""
    A = torch.randn(4, 3, 3, device=card)
    with pytest.raises(ValueError):
        pose_cuda.kabsch_cuda(A.transpose(1, 2), A)
    with pytest.raises(ValueError):
        pose_cuda.kabsch_cuda(A, A.cpu())
    with pytest.raises(RuntimeError):
        pose_cuda.kabsch_cuda(A.requires_grad_(), A.detach())
    pose, src, tgt, valid, th = _irls_inputs(card, "full")
    with pytest.raises(ValueError):
        pose_cuda.irls_cuda(pose.T, src, tgt, valid, th, 10)


def _conv_layer(card, conv, g):
    """``conv`` with drawn weights and bias on the card, and an eval-mode
    affine-free batch norm with drawn running statistics after it."""
    C = conv.out_channels
    conv = conv.to(card)
    with torch.no_grad():
        conv.bias.copy_(torch.randn(C, device=card, generator=g))
    bn = (torch.nn.BatchNorm2d if isinstance(conv, torch.nn.Conv2d)
          else torch.nn.BatchNorm3d)(C, affine=False).to(card).eval()
    bn.running_mean.copy_(torch.randn(C, device=card, generator=g))
    bn.running_var.copy_(torch.rand(C, device=card, generator=g) * 3 + 0.05)
    return conv, bn


def _equi_pair(card, g, K=1500):
    """des1 and des2 of K matches as the pipeline hands them to the cost
    volume: a band of the permuted normalized map, and its rows gathered."""
    equi = torch.nn.functional.normalize(
        torch.randn(2 * K, 32, 7, 20, device=card, generator=g),
        dim=1).permute(0, 2, 3, 1)
    tgt = torch.randint(0, K, (K,), device=card, generator=g)
    return equi[:K, 1:6], equi[K:, 1:6][tgt]


# the convolution kernel sums in another order than cuDNN (one float32
# chain over Cin x taps, up to 1152 products; cuDNN's shorter chains land
# up to ~4 times nearer the float64 convolution on some layers): its
# largest gap to the float64 convolution may be CONV_FACTOR times cuDNN's
# plus CONV_FLOOR of the output's largest magnitude (float32's 2^-23 times
# sqrt(1152)); chip_smoke.py holds every call of a pair to the same gate
CONV_FACTOR, CONV_FLOOR = 4.0, 4e-6


def _wide(module):
    import copy
    return None if module is None else copy.deepcopy(module).double()


def _conv_gate(got, want, exact):
    """The kernel's output ``got`` and cuDNN's ``want`` against the
    float64 ``exact``: (kernel gap, cuDNN gap, bound)."""
    gap = lambda t: float((t.double() - exact).abs().max())
    acc, acc_plain = gap(got), gap(want)
    return acc, acc_plain, CONV_FACTOR * acc_plain + CONV_FLOOR * float(
        exact.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "input spt", "input sampled", "epilogue 64", "epilogue 128 channels last",
    "epilogue conv 0", "costnet channels last", "costnet channels first",
    "cost volume"])
def test_cyl_kernels_match_plain(card, case):
    """The descriptor and cost-volume convolutions and the copies around
    them at the main path's widths (3000 patches, 1500 matches), one
    launch each: conv 0's padded input in the SPT kernel's layout and the
    sampled front's, bit for bit ``pad_cyl_2d`` and stored channels last;
    a cylindrical convolution with its bias, batch norm, ReLU and padded
    write, and CostNet's first convolution with its bias, batch norm and
    ReLU (channels last, and channels first, which the wrapper copies into
    channels last), against the modules in float64 within CONV_FACTOR
    times cuDNN's gap plus CONV_FLOOR; the cost volume bit for bit."""
    from buffer_tpu_torch.kernels.geom_cuda import _pooled_layout
    from buffer_tpu_torch.models.heads import cost_volume
    cuda.build_all()
    g = torch.Generator(card).manual_seed(7)
    if case.startswith("input"):
        if case == "input spt":
            x = _pooled_layout(torch.randn(3000, 16, 420, device=card,
                                           generator=g), 3, 20, 7)
        else:
            x = torch.randn(3000, 3, 7, 20, 16, device=card, generator=g)
        x = x.permute(0, 4, 1, 2, 3)
        name, args = "cyl_pad", (x,)
        kern, plain = cyl_cuda.cyl_pad_cuda, cyl_cuda.cyl_pad_plain
    elif case.startswith("epilogue"):
        if "conv 0" in case:
            conv, bn = _conv_layer(card, torch.nn.Conv3d(16, 64, 3), g)
            x = torch.randn(3000, 16, 3, 9, 22, device=card, generator=g)
        else:
            C = 128 if "128" in case else 64
            conv, bn = _conv_layer(card, torch.nn.Conv2d(64, C, 3), g)
            x = torch.randn(3000, 64, 9, 22, device=card, generator=g)
        if "channels last" in case:
            x = x.contiguous(memory_format=torch.channels_last)
        name, args = "conv", (conv, bn, x)
        kern, plain = conv_cuda.conv_pad_cuda, conv_cuda.conv_pad_plain
    elif case.startswith("costnet"):
        fmt = (torch.channels_last_3d if "last" in case
               else torch.contiguous_format)
        conv, bn = _conv_layer(card, torch.nn.Conv3d(32, 32, 3), g)
        x = torch.randn(1500, 32, 20, 5, 20, device=card, generator=g
                        ).contiguous(memory_format=fmt)
        name, args = "conv", (conv, bn, x)
        kern, plain = conv_cuda.conv_bn_relu_cuda, conv_cuda.conv_bn_relu_plain
    else:
        name, args = "cost_volume", _equi_pair(card, g)
        kern, plain = cyl_cuda.cost_volume_cuda, cost_volume
    with torch.no_grad():
        want = plain(*args)
        before = cuda.launch_counts()[name]
        got = kern(*args)
        if name == "conv":
            exact = plain(_wide(conv), _wide(bn), x.double())
    assert cuda.launch_counts()[name] == before + 1
    if name == "conv":
        acc, acc_plain, bound = _conv_gate(got, want, exact)
        assert got.shape == want.shape and acc <= bound, (acc, acc_plain)
    else:
        assert torch.equal(got, want)
    if name == "cyl_pad":
        xl = conv_cuda.channels_last(got)
        assert xl.data_ptr() == got.data_ptr() and xl.is_contiguous()


def _layer_shapes(B=333, K=157):
    """(net, index, conv, batch norm or None, input shape, wrapper) of each
    of the 18 convolutions at B patches and K matches (by default 333 and
    157: every layer ends on a partial tile, and blocks straddle patches
    and matches)."""
    from buffer_tpu_torch.nn.cylindrical import CostNet, CylindricalNet
    cyl, cost = CylindricalNet(), CostNet(20)
    out, x = [], (B, 16, 3, 9, 22)
    for i, grp in enumerate(cyl.layers):
        last = len(grp) == 1
        out.append(("cyl", i, grp[0], None if last else grp[1], x,
                    "conv_bias" if last else "conv_pad"))
        x = (B, grp[0].out_channels, 9, 22)
    x = (K, 32, 20, 5, 20)
    for i, grp in enumerate(cost.layers):
        last = len(grp) == 1
        out.append(("costnet", i, grp[0], None if last else grp[1], x,
                    "conv_bias" if last else "conv_bn_relu"))
        k = grp[0].kernel_size
        x = (K, grp[0].out_channels, *[s - q + 1 for s, q in zip(x[2:], k)])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layer", range(18))
def test_conv_kernel_matches_float64_at_layer_shapes(card, layer):
    """Each of the 18 convolutions of CylindricalNet and CostNet at its
    widths, 333 patches and 157 matches (a partial tile of rows in every
    layer): the kernel within CONV_FACTOR times cuDNN's gap plus
    CONV_FLOOR of the float64 convolution with its epilogue, the shape of
    the modules' output, one launch, and the same bits on a second
    launch."""
    cuda.build_all()
    net, i, conv, bn, shape, site = _layer_shapes()[layer]
    g = torch.Generator(card).manual_seed(20 + layer)
    conv, bn_card = _conv_layer(card, conv, g)
    bn = None if bn is None else bn_card
    fmt = {4: torch.channels_last, 5: torch.channels_last_3d}[len(shape)]
    x = torch.randn(shape, device=card, generator=g).contiguous(
        memory_format=fmt)
    kern = getattr(conv_cuda, f"{site}_cuda")
    plain = getattr(conv_cuda, f"{site}_plain")
    args = (conv, x) if bn is None else (conv, bn, x)
    wide = ((_wide(conv), x.double()) if bn is None
            else (_wide(conv), _wide(bn), x.double()))
    with torch.no_grad():
        before = cuda.launch_counts()["conv"]
        got = kern(*args)
        assert cuda.launch_counts()["conv"] == before + 1
        again = kern(*args)
        want, exact = plain(*args), plain(*wide)
    acc, acc_plain, bound = _conv_gate(got, want, exact)
    assert got.shape == want.shape
    assert acc <= bound, (net, i, acc, acc_plain)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("batches", [(333, 157), (3000, 1500), (1, 1)])
def test_conv_plans_match_the_launcher(card, batches):
    """The launcher's own plan of each of the 18 convolutions (its C
    ``conv_plan``) is ``conv_cuda.plan``'s, at full, partial and single
    batches; the instance it launches keeps two blocks an SM without
    spilling."""
    import ctypes
    fn = conv_cuda.CONV.lib.load().conv_plan
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    for net, i, conv, bn, shape, site in _layer_shapes(*batches):
        store = {"conv_pad": conv_cuda.PAD, "conv_bn_relu": conv_cuda.DENSE,
                 "conv_bias": conv_cuda.BIAS}[site]
        x = torch.empty(shape)
        (B, D, H, W, C), k = conv_cuda._dims(conv, x)
        want = conv_cuda.plan(B, D, H, W, C, conv.out_channels, *k, store)
        got = (ctypes.c_int * 9)()
        fn(B, D, H, W, C, conv.out_channels, *k, store, got)
        assert list(got) == [int(want.path == "tap"), *want[1:]], (net, i)
        attrs = conv_cuda.attributes(B, D, H, W, C, conv.out_channels, *k,
                                     store)
        assert attrs["blocks_per_sm"] == 2 and attrs["local_bytes"] == 0, (
            net, i, attrs)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [0, 50])
def test_cyl_kernels_split_the_batch(card, monkeypatch, batch):
    """A map past a launch's elements is split along its batch, one launch
    a part, and an empty batch launches nothing: conv 0's padded input and
    the cost volume bit for bit their plain versions (the bound lowered to
    30888 elements, so that 50 items take 4 parts); the convolution kernel
    launches nothing for an empty batch and gives its shape."""
    from buffer_tpu_torch.models.heads import cost_volume
    cuda.build_all()
    g = torch.Generator(card).manual_seed(10)
    conv, bn = _conv_layer(card, torch.nn.Conv2d(8, 12, 3), g)
    x = torch.randn(batch, 8, 9, 22, device=card, generator=g).contiguous(
        memory_format=torch.channels_last)
    vol = tuple(d[:batch] for d in _equi_pair(card, g, K=50))
    limit = 13 * 12 * 9 * 22
    monkeypatch.setattr(cyl_cuda, "LAUNCH_ELEMENTS", limit)

    def parts(per):             # items of ``per`` elements a launch
        return -(-batch // ((limit - 1) // per))
    for name, kern, plain, args, launches in (
            ("cyl_pad", cyl_cuda.cyl_pad_cuda, cyl_cuda.cyl_pad_plain,
             (x,), parts(8 * 11 * 24)),
            ("cost_volume", cyl_cuda.cost_volume_cuda, cost_volume, vol,
             int(batch > 0))):
        with torch.no_grad():
            want = plain(*args)
            before = cuda.launch_counts()[name]
            got = kern(*args)
        assert cuda.launch_counts()[name] == before + launches, name
        assert torch.equal(got, want), name
    assert batch == 0 or parts(8 * 11 * 24) == 4
    with torch.no_grad():
        before = cuda.launch_counts()["conv"]
        got = conv_cuda.conv_pad_cuda(conv, bn, x)
        assert cuda.launch_counts()["conv"] == before + int(batch > 0)
        assert got.shape == conv_cuda.conv_pad_plain(conv, bn, x).shape


def _forward_gate(got, want, exact) -> None:
    """Each output of the kernel path within CONV_FACTOR times the plain
    path's gap to the float64 path plus CONV_FLOOR of its scale."""
    for a, b, e in zip(got, want, exact):
        acc, acc_plain, bound = _conv_gate(a, b, e)
        assert acc <= bound, (acc, acc_plain)


@pytest.mark.cuda
def test_descriptor_and_cost_volume_forward_kernels_match_plain(card):
    """A MiniSpinNet forward over 3000 pooled maps and a CostVolume forward
    over 1500 matches in inference, through the kernels and through the
    plain versions (substituted at their call sites), against the plain
    versions in float64: descriptors, equivariant maps and azimuths within
    the convolutions' gate; the kernels launch 1 padded input, 18
    convolutions and 1 volume, and repeat bit for bit."""
    from buffer_tpu_torch.kernels.geom_cuda import _pooled_layout
    from buffer_tpu_torch.models.heads import CostVolume
    from buffer_tpu_torch.models.patch_embedder import MiniSpinNet
    cuda.build_all()
    g = torch.Generator(card).manual_seed(8)
    desc, cv = MiniSpinNet().to(card).eval(), CostVolume(20).to(card).eval()
    for mod in (desc, cv):
        for b in mod.modules():
            if isinstance(b, torch.nn.modules.batchnorm._BatchNorm):
                b.running_mean.copy_(0.1 * torch.randn(
                    b.num_features, device=card, generator=g))
                b.running_var.copy_(0.5 + torch.rand(
                    b.num_features, device=card, generator=g))
    pooled = _pooled_layout(torch.rand(3000, 16, 420, device=card, generator=g),
                            3, 20, 7)
    tgt = torch.randint(0, 1500, (1500,), device=card, generator=g)

    def forward(desc, cv, pooled):
        with torch.no_grad():
            d, e = desc(pooled)
            return d, e, cv(e[:1500, 1:6], e[1500:, 1:6][tgt])
    cuda.reset_launches()
    got = forward(desc, cv, pooled)
    assert {k: v for k, v in cuda.launch_counts().items() if v} == {
        "cyl_pad": 1, "conv": 18, "cost_volume": 1}
    assert all(torch.equal(a, b) for a, b in zip(got, forward(desc, cv, pooled)))
    with sites.plain_versions():
        want = forward(desc, cv, pooled)
        exact = forward(_wide(desc), _wide(cv), pooled.double())
    _forward_gate(got, want, exact)


@pytest.mark.cuda
def test_program_plain_versions_match_kernel_path(card):
    """One registration program at the 3DMatch plan through the kernels,
    and two built under ``plain_versions``: with the convolutions kept on
    their kernel (``sites.CONVOLUTIONS``), the same keypoints and mutual
    count, descriptors within 2e-5 (the SPT front's gate), the pose within
    1e-5; through every plain version (cuDNN's convolutions too, which sum
    in another order), the same keypoints and descriptors within 2e-5.  A
    replay of the kernel program launches conv 0's padded input, the 18
    convolutions and the volume; of the plain ones, the 18 convolutions
    and no kernel."""
    cuda.build_all()
    cfg = threedmatch_cfg()
    model = BufferModel(cfg, seed=0).to(card)
    pair = surface_pair(cfg, 0, card)[0]
    draws = registration.make_draws(cfg, torch.Generator(card).manual_seed(0),
                                    card)
    fn = registration.make_register_fn(model, return_intermediates=True)
    fn(pair, draws)
    cuda.reset_launches()
    res_k, int_k = fn(pair, draws)
    rose = cuda.launch_counts()
    assert {k: rose[k] for k in ("cyl_pad", "conv", "cost_volume")} == {
        "cyl_pad": 1, "conv": 18, "cost_volume": 1}
    outs = []
    for keep in (sites.CONVOLUTIONS, ()):
        with sites.plain_versions(keep=keep):
            plain = registration.make_register_fn(model,
                                                  return_intermediates=True)
            plain(pair, draws)
            cuda.reset_launches()
            outs.append(plain(pair, draws))
            assert {k: v for k, v in cuda.launch_counts().items() if v} == (
                {"conv": 18} if keep else {})
    for res_p, int_p in outs:
        assert torch.equal(int_k["kidx"], int_p["kidx"])
        for name in ("s_des", "t_des", "s_equi", "t_equi"):
            torch.testing.assert_close(int_k[name], int_p[name], rtol=0,
                                       atol=2e-5)
    res_p, int_p = outs[0]
    assert int(res_k.num_mutual) == int(res_p.num_mutual)
    torch.testing.assert_close(res_k.pose, res_p.pose, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cyl_wrappers_raise(card):
    """A CUDA tensor the fused passes do not take raises (no fallback): a
    layer on another device, an input asking for a gradient, descriptors
    on two devices."""
    g = torch.Generator(card).manual_seed(9)
    conv, bn = _conv_layer(card, torch.nn.Conv2d(8, 8, 3), g)
    x = torch.randn(4, 8, 9, 22, device=card)
    with torch.no_grad():
        with pytest.raises(ValueError):
            conv_cuda.conv_pad_cuda(conv.cpu(), bn, x)
    with pytest.raises(RuntimeError):
        conv_cuda.conv_bn_relu_cuda(conv.to(card), bn, x)
    with pytest.raises(RuntimeError):
        cyl_cuda.cyl_pad_cuda(x.requires_grad_())
    d = torch.randn(3, 5, 20, 32, device=card)
    with pytest.raises(ValueError):
        cyl_cuda.cost_volume_cuda(d, d.cpu())


def _tail_front(card, K=400):
    """A ``Front`` of K rigid correspondences with 80 outliers, every one a
    mutual match and a vote inlier: all that ``pair_tail`` reads."""
    src, tgt = (torch.from_numpy(x[0]).to(card) for x in
                _rigid_set(np.random.RandomState(3), 1, K, 0.003, outliers=80))
    every = torch.ones(K, dtype=torch.bool, device=card)
    return registration.Front(ss_kpts=src, tt_kpts=tgt, mutual=every,
                              vote_inliers=every, num_mutual=every.sum(),
                              kpts=None, kpt_valid=None)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["3DMatch", "KITTI"])
def test_tail_capture_launches_the_pose_kernels(card, preset):
    """The boost tail captured in a CUDA graph: its capture counts 2 Kabsch
    launches (the hypotheses, the refit) and 1 IRLS launch where the preset
    refines the pose (KITTI: none), and its replay equals the eager tail bit
    for bit and the plain tail's pose to 1e-5."""
    cuda.build_all()
    cfg = threedmatch_cfg() if preset == "3DMatch" else kitti_cfg()
    front = _tail_front(card)
    H = 4 * cfg.match.hypotheses
    gen = torch.Generator(card).manual_seed(0)
    u = torch.rand((H, 3, front.ss_kpts.shape[0]), generator=gen, device=card)
    gumbel = -torch.log(-torch.log(u.clamp(1e-7, 1 - 1e-7)))
    iters = 2 * cfg.static.refine_iters
    with torch.no_grad(), registration.full_fp32():
        want = registration.pair_tail(cfg, front, gumbel, iters)
        with sites.plain_versions():
            plain = registration.pair_tail(cfg, front, gumbel, iters)
        torch.cuda.synchronize()
        cuda.reset_launches()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = registration.pair_tail(cfg, front, gumbel, iters)
        rose = {k: v for k, v in cuda.launch_counts().items() if v}
        assert rose == ({"kabsch": 2, "irls": 1} if cfg.test.pose_refine
                        else {"kabsch": 2})
        graph.replay()
        torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(got[1], plain[1])
    torch.testing.assert_close(got[0], plain[0], rtol=0, atol=1e-5)


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
    # second again (padding, its result discarded), 3 pairs' launches, each
    # tail 2 Kabsch solves and the IRLS rounds
    assert launches == {"nearest": 6, "fps": 3, "ball_sample": 3,
                        "spt_pooled": 3, "cyl_pad": 3, "conv": 54,
                        "cost_volume": 3, "kabsch": 6, "irls": 3}
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
    launch counts are the eager pair's, and the first call's those and the
    tail its warm-up runs besides (the budget the pair does not take)."""
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
    untaken = {"kabsch": 2, "irls": int(cfg.test.pose_refine)}
    got = []
    for _ in range(2):
        for p, d, w in zip(pairs, draws, want):
            cuda.reset_launches()
            built = len(fn.programs)
            got.append((fn(p, d), w))
            warm = len(fn.programs) - built
            assert cuda.launch_counts() == {
                k: v // 2 + warm * untaken.get(k, 0) for k, v in eager.items()}
            assert all(torch.equal(a, b) for a, b in zip(*got[-1]))
            assert registration.boost_taken(cfg, got[-1][0].num_mutual) == (th > 0)
    for res, w in got:
        assert all(torch.equal(a, b) for a, b in zip(res, w))
    (program,) = fn.programs.values()
    (chain,) = program.chains
    assert sorted(chain.tails) == [False, True]


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
    the group takes both tails; a call launches three pairs' kernels (the
    first also each chain's warm-up of the tail its pair does not take)
    and makes one host read; every chain has its own stream and memory
    pool; a result keeps its values through the calls after it."""
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
    want = [single(p, d) for p, d in zip(pairs, draws)]
    cuda.reset_launches()
    want = [single(p, d) for p, d in zip(pairs, draws)]    # replays
    per_pair = {k: v // 3 for k, v in cuda.launch_counts().items()}
    untaken = {"kabsch": 2, "irls": int(cfg.test.pose_refine)}
    fn = registration.make_unrolled_register_fn(model, 3)
    got = []
    for n_call in range(3):
        cuda.reset_launches()
        built = len(fn.programs)
        res, syncs = _sync_count(lambda: fn(pairs, draws))
        got.append(res)
        chains = 3 * (len(fn.programs) - built)     # built in this call
        assert cuda.launch_counts() == {
            k: 3 * v + chains * untaken.get(k, 0) for k, v in per_pair.items()}
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


class _TimedGraph:
    """A captured graph whose replays are bracketed by plain timing events
    on the replaying stream, after a spin of ``lead`` clock cycles queued
    ahead of the first event."""

    def __init__(self, graph, lead: int):
        self.graph, self.lead, self.spans = graph, lead, []

    def replay(self):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(self.lead)
        a.record()
        self.graph.replay()
        b.record()
        self.spans.append((a, b))


def _one_node_graph_ms(stream, lead: int, reps: int = 10) -> float:
    """Median span of a captured graph of one small kernel replayed on
    ``stream`` as :class:`_TimedGraph` times a replay: a graph launch and
    one small node."""
    x = torch.zeros(1, device=stream.device)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        x.add_(1)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            x.add_(1)
        timed = _TimedGraph(graph, lead)
        for _ in range(reps):
            timed.replay()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in timed.spans)


def _three_pairs(card, plan="tiny"):
    cfg, pairs = _program_pairs(plan, card)
    if plan == "tiny":
        pairs.append(_tiny_pair(cfg, card, 700, 0.4))
    else:
        pairs.append(surface_pair(cfg, 2, card)[0])
    gen = torch.Generator(card).manual_seed(0)
    return cfg, pairs, [registration.make_draws(cfg, gen, card) for _ in pairs]


@pytest.mark.cuda
def test_unrolled_program_stage_spans(card):
    """A replayed ``make_unrolled_register_fn`` at the 3DMatch plan (U = 3,
    IRLS on): every call leaves a record, every stage span of every chain
    is positive, and a chain's front and tail stages add up, within 2%, to
    the spans of the same replays of its front and tail graphs timed by
    plain events around them (:class:`_TimedGraph`), less the span of a
    graph of one small node timed the same way: a graph's launch, and a
    node like the one after a tail's last mark (the RANSAC inlier count),
    which together are ~2% of a ~0.65 ms tail.  Each replay waits behind a
    spin of ~1 ms (2e6 cycles at 1980 MHz), so the card records the first
    outer event only once the host has submitted the whole graph (else the
    span holds the host's launch time, up to 0.05 ms); the tails' spins
    grow by ~2 ms a chain, so each tail runs alone and no other chain's
    kernels hold back its last node (which otherwise waited up to
    0.08 ms)."""
    cuda.build_all()
    cfg, pairs, draws = _three_pairs(card, "3DMatch")
    model = BufferModel(cfg, seed=0).to(card)
    fn = registration.make_unrolled_register_fn(model, 3)
    fn(pairs, draws)
    (program,) = fn.programs.values()
    lead = 2_000_000
    for j, c in enumerate(program.chains):
        c.front_graph = _TimedGraph(c.front_graph, lead)
        c.tails = {b: (_TimedGraph(g, (1 + 2 * j) * lead), out, n)
                   for b, (g, out, n) in c.tails.items()}
    t0 = time.perf_counter()
    for _ in range(3):
        fn(pairs, draws).pose.cpu()
    recs = profiling.call_records(t0, time.perf_counter())
    assert profiling.unread_calls(t0, time.perf_counter()) == 0
    launch = _one_node_graph_ms(program.chains[0].stream, lead)
    assert [r["unroll"] for r in recs] == [3, 3, 3]
    assert recs[0]["call_gap_ms"] is None          # first after the capture
    FRONT, TAIL = registration.StageTimer.FRONT, registration.StageTimer.TAIL
    for k, rec in enumerate(recs):
        assert rec["load_ms"] > 0 and rec["tail_gap_ms"] > 0
        assert k == 0 or rec["call_gap_ms"] > 0
        for c, st in zip(program.chains, rec["stages"]):
            assert tuple(st) == registration.StageTimer.STAGES
            assert all(v > 0 for v in st.values()), st
            a, b = c.front_graph.spans[k]
            assert sum(st[s] for s in FRONT) == pytest.approx(
                a.elapsed_time(b) - launch, rel=0.02)
            (tail,) = [g for g, _, _ in c.tails.values() if g.spans]
            a, b = tail.spans[k]
            assert sum(st[s] for s in TAIL) == pytest.approx(
                a.elapsed_time(b) - launch, rel=0.02)


@pytest.mark.cuda
def test_register_pair_stage_timer(card):
    """The eager ``register_pair`` with a :class:`StageTimer`: nine marks,
    seven positive stage spans (IRLS on at the tiny plan)."""
    cuda.build_all()
    cfg, (pair, _) = _program_pairs("tiny", card)
    model = BufferModel(cfg, seed=0).to(card)
    draws = registration.make_draws(cfg, torch.Generator(card).manual_seed(1),
                                    card)
    timer = registration.StageTimer()
    registration.register_pair(model, pair, draws, timer=timer)
    ms = timer.stage_ms()
    assert len(timer.events) == 9
    assert tuple(ms) == registration.StageTimer.STAGES
    assert all(v > 0 for v in ms.values()), ms


@pytest.mark.cuda
def test_program_outputs_equal_with_and_without_profiler(card):
    """Poses and counts of the unrolled and the one-pair program, bit-equal
    with ``torch.profiler`` running (the program's spans open) and without
    it."""
    from torch.profiler import ProfilerActivity, profile
    cuda.build_all()
    cfg, pairs, draws = _three_pairs(card)
    model = BufferModel(cfg, seed=0).to(card)
    unrolled = registration.make_unrolled_register_fn(model, 3)
    single = registration.make_register_fn(model)
    calls = [lambda: unrolled(pairs, draws),
             lambda: single(pairs[0], draws[0])]
    for call in calls:
        call()
    plain = [graphs.clone(call()) for call in calls]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = [graphs.clone(call()) for call in calls]
        torch.cuda.synchronize()
    for p, t in zip(plain, traced):
        assert all(torch.equal(a, b) for a, b in zip(p, t))
    names = {e.name for e in prof.events()}
    assert {"register.call", "register.load", "register.front",
            "register.mutual_read", "register.tail",
            "register.outputs"} <= names


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
