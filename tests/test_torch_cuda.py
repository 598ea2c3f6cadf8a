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
