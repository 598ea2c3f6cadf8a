"""The slice end to end: the port's ``register_pair(device="cpu")`` against
the JAX package's ``register_pair`` at the tiny plan, with the same inputs
(``prepare_pair`` from one seed), the same weights and JAX's own random
draws, split from the key exactly as ``registration.py:185,150,162`` and
``ransac.py:43`` split it.

The JAX CPU path thins the fused SPT front by Bernoulli draws
(``patch_embedder.py:326-330``), which is not the kernel's semantics the
port implements; this test holds JAX to the kernel's semantics by
replacing ``fused_point_features`` with a function that folds the weights
as ``patch_embedder.py:276-294`` does and runs ``spt_pooled_tpu`` in Pallas
interpret mode.  Nothing in the JAX package changes."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import buffer_tpu.config as jconfig
import buffer_tpu.kernels.geom_pallas as gp
from buffer_tpu.core import gridmath as jgridmath
from buffer_tpu.data import preprocess as jpre
from buffer_tpu.models import patch_embedder as jpe
from buffer_tpu.models.composite import BufferModel as JModel
from buffer_tpu.pipeline.registration import register_pair as j_register_pair

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.compat.from_jax import variables_to_state_dict
from buffer_tpu_torch.data.preprocess import prepare_pair
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.pipeline.registration import Draws, register_pair

torch.set_num_threads(1)


def _fused_kernel_semantics(desc_params, desc_stats, key, delta_x, rad_n,
                            azi_n, ele_n, voxel_r, voxel_sample,
                            kpt_chunk=128, R_align=None, delta_planes=None):
    W = desc_params["pnt_conv"]["kernel"]
    b = desc_params["pnt_conv"]["bias"]
    scale = desc_params["pnt_bn"]["weight"] / jnp.sqrt(desc_stats["pnt_bn"]["var"] + 1e-5)
    W_eff = W * scale[None, :]
    b_eff = (b - desc_stats["pnt_bn"]["mean"]) * scale + desc_params["pnt_bn"]["bias"]
    R = jnp.asarray(jgridmath.azimuth_derotations(azi_n), delta_x.dtype)
    W_all = jnp.einsum("aji,jc->aic", R, W_eff)
    f0 = jax.nn.relu(b_eff)
    u = jax.random.uniform(key, (delta_x.shape[1],))
    return gp.spt_pooled_tpu.__wrapped__(
        W_all, b_eff, f0, u, delta_x, rad_n, azi_n, ele_n, float(voxel_r),
        int(voxel_sample), R=R_align)


def _surface(n, seed):
    rs = np.random.RandomState(seed)
    pts = rs.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    pts[:, 2] = (0.25 * np.sin(4 * pts[:, 0]) + 0.2 * np.cos(3 * pts[:, 1])
                 + 0.08 * np.sin(11 * pts[:, 0] * pts[:, 1]) + 1.5)
    return pts


def _jax_draws(key, cfg):
    """The draws JAX's register_pair makes from ``key`` on the CPU path."""
    _, k_desc0, k_desc1, k_ransac = jax.random.split(key, 4)
    R, S = cfg.static.raw_points, cfg.patch.num_points_per_patch
    ball = [jax.random.uniform(jax.random.split(k)[0], (R,), dtype=jnp.float32)
            for k in (k_desc0, k_desc1)]
    spt = jax.random.uniform(jax.random.split(k_desc0)[1], (S,))
    gumbel = jax.random.gumbel(k_ransac, (cfg.match.hypotheses, 3,
                                          cfg.point.num_keypts))
    t = lambda a: torch.from_numpy(np.array(a))
    return Draws(t(jnp.stack(ball)), t(spt), t(gumbel))


def test_register_pair_matches_jax(monkeypatch):
    monkeypatch.setattr(gp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jpe, "fused_point_features", _fused_kernel_semantics)
    jcfg, tcfg = jconfig.tiny_cfg(), tconfig.tiny_cfg()
    # a small shift keeps matched keypoints close under random weights, so
    # RANSAC and IRLS find inliers and the pose comparison is not trivial
    raw = _surface(900, 0)
    tgt = raw + np.float32([0.02, -0.01, 0.015])
    j_inputs = jpre.prepare_pair(jcfg, raw.copy(), tgt.copy(),
                                 rs=np.random.RandomState(3),
                                 already_downsampled=True)
    t_inputs = prepare_pair(tcfg, raw.copy(), tgt.copy(),
                            rs=np.random.RandomState(3),
                            already_downsampled=True, device="cpu")
    for g, w in zip(t_inputs, j_inputs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    jm = JModel(jcfg)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0))
    model = BufferModel(tcfg)
    model.load_state_dict({k: torch.tensor(v) for k, v in variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)).items()})

    key = jax.random.PRNGKey(7)
    res_j, inter_j = jax.jit(lambda v, i, k: j_register_pair(
        jm, v, i, k, return_intermediates=True))(variables, j_inputs, key)
    res, inter = register_pair(model, t_inputs, _jax_draws(key, jcfg),
                               device="cpu", return_intermediates=True)

    pj, pt = inter_j["pyramid"], inter["pyramid"]
    for lvl in range(2):
        np.testing.assert_array_equal(pt.upsamples[lvl].numpy(),
                                      np.asarray(pj.upsamples[lvl]))
    for lvl in range(3):
        v = np.asarray(pj.neighbor_valid[lvl])
        np.testing.assert_array_equal(pt.neighbor_valid[lvl].numpy(), v)
        np.testing.assert_array_equal(  # same sets; rounding ties may swap
            np.sort(np.where(v, pt.neighbors[lvl].numpy(), -1), -1),
            np.sort(np.where(v, np.asarray(pj.neighbors[lvl]), -1), -1))
    # saliency to fp32 reordering; keypoint indices exactly equal
    np.testing.assert_allclose(inter["score"].numpy(), np.asarray(inter_j["score"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(inter["kidx"].numpy(), np.asarray(inter_j["kidx"]))
    np.testing.assert_array_equal(res.kpt_valid.numpy(), np.asarray(res_j.kpt_valid))
    assert res.kpt_valid.any()
    # descriptors: the CNN sums in another order (1e-4); beyond that a
    # patch point or SPT winner may flip where its in-ball test sits within
    # rounding of the radius (millions of tests per pair), which moves that
    # keypoint's descriptor a little: allow it for a few keypoints
    for name in ("s_des", "t_des"):
        err = np.abs(inter[name].numpy() - np.asarray(inter_j[name])).max(-1)
        assert (err > 1e-4).mean() <= 0.05 and err.max() < 0.05, (name, err.max())
    np.testing.assert_array_equal(inter["matches"].tgt_idx.numpy(),
                                  np.asarray(inter_j["matches"].tgt_idx))
    assert int(res.num_mutual) == int(res_j.num_mutual) > 0
    # the reference permutes the target maps through a bf16 hi/lo one-hot
    # product, exact only to ~1e-5 relative; the port gathers exactly
    np.testing.assert_allclose(inter["azi_ind"].numpy(), np.asarray(inter_j["azi_ind"]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(inter["vote_inliers"].numpy(),
                                  np.asarray(inter_j["vote_inliers"]))
    assert int(res.num_inliers) == int(res_j.num_inliers)
    np.testing.assert_allclose(res.pose.numpy(), np.asarray(res_j.pose),
                               rtol=1e-3, atol=1e-3)
