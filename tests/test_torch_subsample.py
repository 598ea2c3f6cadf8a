"""The port's voxel-grid subsampling against the JAX package on the CPU.

``voxel_subsample`` (the device version: key sort, segment mean, compaction
to ``out_size``) on the same clouds, made from numpy seeds: the masks bit
for bit and the points within 1e-6 (both sum each voxel's points in sorted
order in fp32, so they agree exactly in practice).  ``voxel_subsample_np``
(the host version) exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from buffer_tpu.ops import subsample as jsub

from buffer_tpu_torch.ops import subsample

torch.set_num_threads(1)


def _random(rs):
    pts = rs.uniform(-0.8, 1.1, (3000, 3)).astype(np.float32)
    return pts, rs.rand(3000) > 0.2, 0.07, 3000


def _overflow(rs):
    pts = rs.uniform(0.0, 2.0, (4000, 3)).astype(np.float32)
    return pts, np.ones(4000, bool), 0.05, 300


def _all_invalid(rs):
    pts = rs.uniform(-1.0, 1.0, (500, 3)).astype(np.float32)
    return pts, np.zeros(500, bool), 0.07, 128


def _padded_zeros(rs):
    # invalid zero rows at the centre of the valid cloud's box, as the
    # static padding of a cloud that straddles the origin
    pts = rs.uniform(-0.5, 0.5, (2000, 3)).astype(np.float32)
    valid = np.ones(2000, bool)
    pts[1500:] = 0.0
    valid[1500:] = False
    return pts, valid, 0.035, 2048


def _coincident(rs):
    base = rs.uniform(0.2, 0.9, (200, 3)).astype(np.float32)
    pts = np.repeat(base, 5, axis=0)
    rs.shuffle(pts)
    return pts, rs.rand(1000) > 0.1, 0.02, 512


@pytest.mark.parametrize("make", [_random, _overflow, _all_invalid,
                                  _padded_zeros, _coincident],
                         ids=lambda f: f.__name__[1:])
def test_voxel_subsample_matches_jax(make):
    pts, valid, voxel, out_size = make(np.random.RandomState(11))
    want, want_mask = jsub.voxel_subsample(jnp.asarray(pts), jnp.asarray(valid),
                                           voxel, out_size)
    got, got_mask = subsample.voxel_subsample(torch.from_numpy(pts),
                                              torch.from_numpy(valid), voxel,
                                              out_size)
    assert got.shape == (out_size, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    n = int(got_mask.sum())
    if make is _overflow:
        assert n == out_size
    elif make is not _all_invalid:
        assert 0 < n < out_size
    if make is _all_invalid:
        assert n == 0 and not got.any()


@pytest.mark.parametrize("voxel", [0.05, 0.3])
def test_voxel_subsample_np_matches_jax(voxel):
    rs = np.random.RandomState(5)
    pts = rs.uniform(-2.0, 3.0, (5000, 3)).astype(np.float32)
    np.testing.assert_array_equal(subsample.voxel_subsample_np(pts, voxel),
                                  jsub.voxel_subsample_np(pts, voxel))
    empty = np.zeros((0, 3), np.float32)
    assert subsample.voxel_subsample_np(empty, voxel).shape == (0, 3)
