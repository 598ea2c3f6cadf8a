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

from buffer_tpu_torch.kernels import cuda
from buffer_tpu_torch.kernels import geom_cuda, fps_cuda

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


@pytest.mark.parametrize("n_elig", [None, 25, 0])
def test_fps_plain_matches_pallas(n_elig):
    """Full, under-full (fewer eligible points than samples) and empty
    eligibility: indices must be exactly equal (FPS is chaotic)."""
    rs = np.random.RandomState(7)
    B, N, S = 2, 1024, 40
    pts = rs.randn(B, N, 3).astype(np.float32)
    elig = rs.rand(B, N) > 0.3
    if n_elig is not None:
        elig[:] = False
        for b in range(B):
            elig[b, rs.choice(N, n_elig, replace=False)] = True
    want = np.asarray(fp.fps_pallas_batched(jnp.asarray(pts),
                                            jnp.asarray(elig), S))
    got = fps_cuda.fps_plain(_t(pts), _t(elig), S).numpy()
    np.testing.assert_array_equal(got, want)


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
