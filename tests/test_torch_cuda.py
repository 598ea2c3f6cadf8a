"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and skip without one (a CUDA kernel has no
CPU mode).  The file imports neither JAX nor the JAX package, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from buffer_tpu_torch.config import tiny_cfg
from buffer_tpu_torch.kernels import cuda, fps_cuda, geom_cuda
from buffer_tpu_torch.models import patch_embedder
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.ops import neighbors, sampling
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
def test_register_pair_kernels_match_plain_path(card, monkeypatch):
    """A tiny pair on the card through the kernels and through the plain
    versions (substituted at the kernels' call sites): identical keypoints
    and matches, the same pose to 1e-5."""
    cfg = tiny_cfg()
    rs = np.random.RandomState(0)
    raw = rs.uniform(-0.6, 0.6, (900, 3)).astype(np.float32)
    raw[:, 2] = 0.25 * np.sin(4 * raw[:, 0]) + 0.2 * np.cos(3 * raw[:, 1]) + 1.5
    from buffer_tpu_torch.data.preprocess import prepare_pair
    inputs = prepare_pair(cfg, raw, raw + np.float32(0.02),
                          rs=np.random.RandomState(1), already_downsampled=True,
                          device=card)
    model = BufferModel(cfg).to(card)
    draws = registration.make_draws(cfg, torch.Generator(card).manual_seed(0), card)
    cuda.reset_launches()
    res_k, int_k = registration.register_pair(model, inputs, draws,
                                              return_intermediates=True)
    assert min(cuda.launch_counts().values()) > 0
    for mod, name, plain in (
            (neighbors, "nearest_cuda", geom_cuda.nearest_plain),
            (neighbors, "ball_sample_planes_cuda",
             geom_cuda.ball_sample_planes_plain),
            (sampling, "fps_cuda_batched", fps_cuda.fps_plain),
            (patch_embedder, "spt_pooled_cuda", geom_cuda.spt_pooled_plain)):
        monkeypatch.setattr(mod, name, plain)
    cuda.reset_launches()
    res_p, int_p = registration.register_pair(model, inputs, draws,
                                              return_intermediates=True)
    assert max(cuda.launch_counts().values()) == 0
    assert torch.equal(int_k["kidx"], int_p["kidx"])
    assert int(res_k.num_mutual) == int(res_p.num_mutual)
    torch.testing.assert_close(res_k.pose, res_p.pose, rtol=1e-5, atol=1e-5)
