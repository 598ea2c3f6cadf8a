"""The port's kernels: each plain PyTorch version against the JAX package's
Pallas kernel run in interpret mode (the kernel's own contract), and the
CPU dispatch of each wrapper.  On the CPU a wrapper runs its plain version;
the CUDA kernels themselves are held against the plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  Inputs come from
numpy seeds; priorities are JAX's own ``jax.random.uniform`` draws, fed to
both sides."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import buffer_tpu.kernels.fps_pallas as fp
import buffer_tpu.kernels.geom_pallas as gp
from buffer_tpu.core import gridmath as jgridmath

from buffer_tpu_torch.config import threedmatch_cfg, tiny_cfg
from buffer_tpu_torch.core import se3
from buffer_tpu_torch.kernels import cuda
from buffer_tpu_torch.kernels import geom_cuda, fps_cuda, pose_cuda, sites
from buffer_tpu_torch.pipeline import ransac, refine

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    for mod in (gp, fp):
        monkeypatch.setattr(mod.pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_nearest_plain_matches_pallas():
    rs = np.random.RandomState(1)
    B, N, Q = 2, 512, 50
    sup = rs.randn(B, N, 3).astype(np.float32)
    valid = rs.rand(B, N) > 0.15
    q = (rs.randn(B, Q, 3) * 0.5).astype(np.float32)
    d, i = geom_cuda.nearest_plain(_t(q), _t(sup), _t(valid))
    for b in range(B):
        dj, ij = gp.nearest_tpu.__wrapped__(
            jnp.asarray(q[b]), jnp.asarray(sup[b]), jnp.asarray(valid[b]),
            q_tile=16, seg=128)
        # same coordinate-difference arithmetic on both sides: indices are
        # exact, distances equal to fp32 rounding of the same expression
        np.testing.assert_array_equal(i[b].numpy(), np.asarray(ij))
        np.testing.assert_allclose(d[b].numpy(), np.asarray(dj), rtol=1e-6,
                                   atol=0)
    assert valid[np.arange(B)[:, None], i.numpy()].all()


def test_nearest_no_valid_support():
    q = torch.zeros((1, 4, 3))
    s = torch.ones((1, 8, 3))
    d, i = geom_cuda.nearest_plain(q, s, torch.zeros((1, 8), dtype=torch.bool))
    assert (i == 0).all() and (d == 1e9).all()


@pytest.mark.parametrize("n_elig", [None, 25, 0, "duplicates", "ragged"])
def test_fps_plain_matches_pallas(n_elig):
    """Full, under-full (fewer eligible points than samples) and empty
    eligibility; exact duplicates in different CTAs' shares of the cluster
    kernel's plan (a far pair that ties on the first step, and a copied
    block); a cloud that fills no plan width (1111 points, 3 CTAs of 384
    threads).  Indices must be exactly equal (FPS is chaotic)."""
    rs = np.random.RandomState(7)
    B, N, S = 2, 1024, 40
    if n_elig == "ragged":
        N = 1111
    pts = rs.randn(B, N, 3).astype(np.float32)
    elig = rs.rand(B, N) > 0.3
    if isinstance(n_elig, int):
        elig[:] = False
        for b in range(B):
            elig[b, rs.choice(N, n_elig, replace=False)] = True
    if n_elig == "duplicates":
        owner = fps_cuda.fps_points(fps_cuda.fps_plan(N))     # [C, T, P]
        cta_of = {int(v): r for r in range(owner.shape[0])
                  for v in owner[r].reshape(-1)}
        i, j = 3, N - 5                       # CTA 0 and the last CTA
        assert cta_of[i] == 0 and cta_of[j] == owner.shape[0] - 1 > 0
        pts[:, i] = pts[:, j] = (40.0, -40.0, 40.0)
        elig[:, [i, j]] = True
        pts[:, N // 2 + 7:N // 2 + 107] = pts[:, 10:110]
    want = np.asarray(fp.fps_pallas_batched(jnp.asarray(pts),
                                            jnp.asarray(elig), S))
    got = fps_cuda.fps_plain(_t(pts), _t(elig), S).numpy()
    np.testing.assert_array_equal(got, want)
    if n_elig == "duplicates":
        assert (got[:, 1] == 3).all()         # the tie goes to the lower index


@pytest.mark.parametrize("N", [1, 31, 1024, 1025, 8192, 30720, 40960, 65536])
def test_fps_plan_owns_every_point_once(N):
    """The cluster kernel's plan: each point owned by exactly one (CTA,
    thread, slot), no CTA empty, at most 16 CTAs a cluster (the
    non-portable size, above 8 only where one cluster of 8 cannot hold the
    cloud at TARGET_THREADS), whole warps, no more than TARGET_THREADS, an
    instantiated number of points a thread."""
    C, T, P = plan = fps_cuda.fps_plan(N)
    assert 1 <= C <= fps_cuda.MAX_CLUSTER == 16
    assert C <= fps_cuda.PORTABLE_CLUSTER or N > 8 * fps_cuda.MIN_CTA_POINTS
    assert T % 32 == 0 and 32 <= T <= fps_cuda.TARGET_THREADS
    assert P in fps_cuda.POINTS_A_THREAD
    idx = fps_cuda.fps_points(plan)
    assert idx.shape == (C, T, P)
    owned = idx[idx < N]
    assert torch.equal(torch.sort(owned).values, torch.arange(N))
    assert (idx < N).reshape(C, -1).any(dim=1).all()


@pytest.mark.parametrize("N", [0, fps_cuda.MAX_POINTS + 1])
def test_fps_plan_rejects_out_of_range(N):
    with pytest.raises(ValueError):
        fps_cuda.fps_plan(N)


@pytest.mark.parametrize("make_cfg", [threedmatch_cfg, tiny_cfg])
def test_spt_plan_at_preset_shapes(make_cfg):
    """The SPT kernel's plan at the preset's shapes (both clouds' keypoints,
    420 anchor columns, 320 patch points in 10 segments) and tiny_cfg's:
    every anchor column of a keypoint has its thread, whole warps, shared
    memory under the 48 KB that needs no opt-in, the blocks cover K."""
    cfg = make_cfg()
    p = cfg.patch
    K = 2 * cfg.point.num_keypts
    NSEG, S_eff = geom_cuda.spt_layout(p.num_points_per_patch, p.voxel_sample)
    A = p.rad_n * p.azi_n * p.ele_n
    AT, KB, threads, smem = geom_cuda.spt_plan(K, S_eff, A, NSEG)
    assert (NSEG, S_eff, A, AT) == (10, 320, 420, 4)
    G = -(-A // AT)
    assert threads % 32 == 0 and KB * G <= threads < KB * G + 32
    assert threads <= geom_cuda.SPT_MAX_THREADS and 1 <= KB <= K
    assert smem == geom_cuda.spt_smem_bytes(S_eff, A, NSEG, KB) <= 48 * 1024
    assert -(-K // KB) * KB >= K > (-(-K // KB) - 1) * KB
    assert KB == 3


def _spt_kernel_model(W_all, b, f0, u, planes, R, rad_n, azi_n, ele_n,
                      voxel_r, vs):
    """csrc/spt.cu's algorithm in PyTorch: each segment staged in ascending
    rank of (priority, then lower index), the winner the last passing
    position, bias and ReLU after the max over winners."""
    (xP, yP, zP), R, u, anchor, NSEG = geom_cuda._spt_prepare(
        planes, R, u, rad_n, azi_n, ele_n, vs)
    ax2, ay2, az2, an = anchor
    wx, wy, wz = geom_cuda.spt_weight_columns(W_all, rad_n * ele_n)
    K, S = xP.shape
    LS = S // NSEG
    r2 = torch.tensor(float(voxel_r) ** 2)
    seg_u = u.reshape(NSEG, LS)
    order = torch.stack([torch.tensor(sorted(
        range(LS), key=lambda q: (float(seg_u[s, q]), -q)))
        for s in range(NSEG)])                             # ascending rank
    perm = (order + torch.arange(NSEG)[:, None] * LS).reshape(-1)
    rot = [xP * R[:, 0, e, None] + yP * R[:, 1, e, None] + zP * R[:, 2, e, None]
           for e in range(3)]
    px, py, pz = (c[:, perm] for c in rot)
    rhs = r2 - (px * px + py * py + pz * pz)
    t = px[..., None] * ax2 + an
    t = t + py[..., None] * ay2
    t = t + pz[..., None] * az2                            # [K, S, A]
    ok = (t <= rhs[..., None]).reshape(K, NSEG, LS, -1)
    pos = torch.arange(LS)[None, None, :, None]
    last = torch.where(ok, pos, torch.full_like(pos, -1)).max(dim=2).values
    valid = last >= 0                                      # [K, NSEG, A]
    at = (last.clamp(min=0) + (torch.arange(NSEG) * LS)[None, :, None])
    win = [torch.gather(c, 1, at.reshape(K, -1)).reshape(at.shape)
           for c in (px, py, pz)]
    v = (win[0][:, :, None, :] * wx + win[1][:, :, None, :] * wy
         + win[2][:, :, None, :] * wz)                     # [K, NSEG, 16, A]
    v = torch.where(valid[:, :, None, :], v, torch.full_like(v, -float("inf")))
    r = torch.clamp(v.max(dim=1).values + b[:, None], min=0.0)
    r = torch.where(valid.any(dim=1)[:, None, :], r,
                    torch.full_like(r, -float("inf")))
    r = torch.where((~valid).any(dim=1)[:, None, :],
                    torch.maximum(r, f0[:, None]), r)
    return geom_cuda._pooled_layout(r, rad_n, azi_n, ele_n)


@pytest.mark.parametrize("ties", [False, True])
def test_spt_kernel_algorithm_matches_plain(ties):
    """The SPT kernel's reordering (rank-ordered segments, the winner as the
    last passing position, bias and ReLU after the max) gives the plain
    version's bits, with distinct priorities and with ties (the first point
    of a segment wins)."""
    rs = np.random.RandomState(5)
    K, S, vs = 7, 512, 10
    rad_n, azi_n, ele_n, voxel_r = 3, 20, 7, 0.8 / 3
    planes = tuple(_t((rs.randn(K, S) * 0.4).astype(np.float32))
                   for _ in range(3))
    R = _t(np.linalg.qr(rs.randn(K, 3, 3))[0].astype(np.float32))
    W_all = _t((rs.randn(azi_n, 3, 16) * 0.5).astype(np.float32))
    b = _t(rs.randn(16).astype(np.float32))
    f0 = torch.relu(b)
    u = rs.rand(S).astype(np.float32)
    if ties:
        u = np.round(u * 4) / 4                 # 5 levels: ties everywhere
    args = (W_all, b, f0, _t(u.astype(np.float32)), planes, R, rad_n, azi_n,
            ele_n, voxel_r, vs)
    got = _spt_kernel_model(*args)
    want = geom_cuda.spt_pooled_plain(*args)
    assert torch.equal(got, want)


def test_ball_sample_plain_matches_pallas():
    rs = np.random.RandomState(0)
    B, N, Q, k, r = 2, 1024, 40, 16, 0.9
    sup = rs.randn(B, N, 3).astype(np.float32)
    valid = rs.rand(B, N) > 0.1
    q = (rs.randn(B, Q, 3) * 0.5).astype(np.float32)
    prio = np.stack([np.asarray(jax.random.uniform(jax.random.PRNGKey(3 + b),
                                                   (N,), dtype=jnp.float32))
                     for b in range(B)])
    x, y, z, v = geom_cuda.ball_sample_planes_plain(
        _t(q), _t(sup), _t(valid), _t(prio), r, k)
    for b in range(B):
        xj, yj, zj, vj = gp.ball_sample_planes_tpu.__wrapped__(
            jax.random.PRNGKey(3 + b), jnp.asarray(q[b]), jnp.asarray(sup[b]),
            jnp.asarray(valid[b]), r, k, q_tile=8)
        vj = np.asarray(vj)
        # same expanded in-ball test and priorities: the selection is exact
        np.testing.assert_array_equal(v[b].numpy(), vj)
        for got, want in ((x, xj), (y, yj), (z, zj)):
            np.testing.assert_array_equal(got[b].numpy()[vj], np.asarray(want)[vj])
            assert (got[b].numpy()[~vj] == 0).all()
    assert v.any() and not v.all()


@pytest.mark.parametrize("vs", [4, 3])
def test_spt_pooled_plain_matches_pallas(vs):
    """vs=3 exercises the dead-segment trim (S=64 -> NSEG=4 > NUSE=3)."""
    rs = np.random.RandomState(2)
    K, S = 6, 64
    rad_n, azi_n, ele_n, voxel_r = 2, 4, 3, 0.4
    delta = (rs.randn(K, S, 3) * 0.4).astype(np.float32)
    W_all = (rs.randn(azi_n, 3, 16) * 0.5).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    f0 = np.maximum(b, 0.0)
    u = rs.rand(S).astype(np.float32)
    q, _ = np.linalg.qr(rs.randn(K, 3, 3))
    R = q.astype(np.float32)
    want = gp.spt_pooled_tpu.__wrapped__(
        jnp.asarray(W_all), jnp.asarray(b), jnp.asarray(f0), jnp.asarray(u),
        jnp.asarray(delta), rad_n, azi_n, ele_n, voxel_r, vs, R=jnp.asarray(R))
    planes = tuple(_t(delta[..., d].copy()) for d in range(3))
    got = geom_cuda.spt_pooled_plain(_t(W_all), _t(b), _t(f0), _t(u), planes,
                                     _t(R), rad_n, azi_n, ele_n, voxel_r, vs)
    # same winners; the MLP sums may round differently (2e-5, as the
    # reference's own kernel test allows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_spt_anchor_columns_match_reference_grid():
    ax2, ay2, az2, an = geom_cuda.spt_anchor_terms(3, 20, 7, "cpu")
    anchors = jgridmath.get_voxel_coordinate(1.0, 3, 20, 7).reshape(-1, 3)
    planes = anchors.reshape(21, 20, 3).transpose(2, 1, 0).reshape(3, -1)
    np.testing.assert_allclose(ax2.numpy(), -2 * planes[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(an.numpy(), (planes ** 2).sum(0), rtol=1e-5)
    assert geom_cuda.spt_layout(512, 10) == (10, 320)


def test_wrappers_take_plain_versions_on_cpu():
    """CPU tensors go to the plain versions and no kernel is launched."""
    cuda.reset_launches()
    rs = np.random.RandomState(3)
    pts = _t(rs.randn(2, 256, 3).astype(np.float32))
    valid = torch.ones((2, 256), dtype=torch.bool)
    d, i = geom_cuda.nearest_cuda(pts[:, :32], pts, valid)
    np.testing.assert_array_equal(i.numpy(), np.tile(np.arange(32), (2, 1)))
    assert (d == 0).all()
    idx = fps_cuda.fps_cuda_batched(pts, valid, 16)
    np.testing.assert_array_equal(idx.numpy(),
                                  fps_cuda.fps_plain(pts, valid, 16).numpy())
    counts = cuda.launch_counts()
    assert {"nearest", "ball_sample", "spt_pooled", "fps"} <= set(counts)
    assert set(counts.values()) == {0}


def test_pose_sites_switch_to_plain_versions():
    """RANSAC's solves and the IRLS loop are kernel call sites:
    ``plain_versions()`` puts the plain versions there and keys the
    compiled programs (``plain_active``), and restores the wrappers."""
    assert (ransac, "kabsch_cuda", se3.kabsch_quat) in sites.call_sites()
    assert (refine, "irls_cuda", pose_cuda.irls_plain) in sites.call_sites()
    assert ransac.kabsch_cuda is pose_cuda.kabsch_cuda
    assert refine.irls_cuda is pose_cuda.irls_cuda
    assert not sites.plain_active()
    with sites.plain_versions():
        assert ransac.kabsch_cuda is se3.kabsch_quat
        assert refine.irls_cuda is pose_cuda.irls_plain
        assert sites.plain_active()
    assert ransac.kabsch_cuda is pose_cuda.kabsch_cuda
    assert refine.irls_cuda is pose_cuda.irls_cuda
    assert {"kabsch", "irls"} <= set(cuda.KERNELS)


def _pose_args(**bad):
    """Arguments of ``irls_cuda`` on CPU tensors, with fields replaced."""
    rs = np.random.RandomState(0)
    args = {"pose": torch.eye(4), "src": _t(rs.randn(50, 3).astype(np.float32)),
            "tgt": _t(rs.randn(50, 3).astype(np.float32)),
            "valid": torch.ones(50, dtype=torch.bool), "inlier_threshold": 0.1,
            "iters": 10}
    args.update(bad)
    return args


@pytest.mark.parametrize("case", [
    "kabsch float64", "kabsch weights float64", "kabsch [N, 3]",
    "kabsch B shape", "kabsch weights shape", "kabsch 2 coordinates",
    "irls float64", "irls valid float", "irls pose [3, 4]", "irls tgt shape",
    "irls valid shape", "irls rounds"])
def test_pose_wrappers_raise_on_bad_inputs(case):
    """The pose solver's wrappers check dtypes and shapes before choosing
    the plain version or the kernel, so a CPU tensor the kernel would not
    take raises too."""
    A = torch.randn(4, 5, 3)
    if case.startswith("kabsch"):
        args = {"kabsch float64": (A.double(), A.double()),
                "kabsch weights float64": (A, A, torch.ones(4, 5,
                                                            dtype=torch.float64)),
                "kabsch [N, 3]": (A[0], A[0]),
                "kabsch B shape": (A, A[:, :4]),
                "kabsch weights shape": (A, A, torch.ones(4, 4)),
                "kabsch 2 coordinates": (A[..., :2], A[..., :2])}[case]
        with pytest.raises(ValueError):
            pose_cuda.kabsch_cuda(*args)
        return
    a = _pose_args()
    bad = {"irls float64": {"src": a["src"].double(), "tgt": a["tgt"].double()},
           "irls valid float": {"valid": a["valid"].float()},
           "irls pose [3, 4]": {"pose": a["pose"][:3]},
           "irls tgt shape": {"tgt": a["tgt"][:40]},
           "irls valid shape": {"valid": a["valid"][:40]},
           "irls rounds": {"iters": -1}}[case]
    with pytest.raises(ValueError):
        pose_cuda.irls_cuda(**_pose_args(**bad))
