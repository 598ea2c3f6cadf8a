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
interpret mode.  Likewise the JAX pyramid takes the TPU path's neighbour
kernels (the banded Pallas kernels in interpret mode, inside its own
``vmap``) where the CPU path would take the XLA fallbacks
``radius_knn_banded``/``nearest_banded``, and with ``fused_desc`` off its
``extract_patches`` takes ``ball_sample_points_tpu`` where the CPU path
would take ``ball_sample``.  Nothing in the JAX package changes."""

import dataclasses
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
from buffer_tpu.pipeline import pyramid as jpyr
from buffer_tpu.pipeline.registration import register_pair as j_register_pair

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.compat.from_jax import variables_to_state_dict
from buffer_tpu_torch.data.preprocess import prepare_pair
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.ops import neighbors
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


def _surface(n, seed, extent=0.6):
    rs = np.random.RandomState(seed)
    pts = rs.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    pts[:, 2] = (0.25 * np.sin(4 * pts[:, 0]) + 0.2 * np.cos(3 * pts[:, 1])
                 + 0.08 * np.sin(11 * pts[:, 0] * pts[:, 1]) + 1.5)
    return pts * np.float32(extent / 0.6)


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


def _tpu_dispatch(monkeypatch):
    """Hold JAX's pyramid to the TPU path's neighbour kernels: the dispatch
    of ``ops/neighbors.py:98-116, 402-411`` with the banded Pallas kernels
    in interpret mode (on the CPU JAX would take its XLA fallbacks)."""
    radius_knn, nearest = jpyr.radius_knn, jpyr.nearest

    def tpu_radius_knn(query, support, support_valid, k, radius=None,
                       band=None, query_valid=None, **kw):
        S = support.shape[0]
        if band is not None and gp.banded_tpu_supported(S):
            wr, covers = gp.banded_win_rows(S, band)
            if 2 * band < S or covers:
                return gp.banded_knn_tpu.__wrapped__(
                    query, support, support_valid, query_valid, k, radius,
                    band=band, win_rows=wr)
        return radius_knn(query, support, support_valid, k, radius, band=band,
                          query_valid=query_valid, **kw)

    def tpu_nearest(query, support, support_valid, band=None,
                    query_valid=None, **kw):
        S = support.shape[0]
        if band is not None and 2 * band < S and gp.banded_tpu_supported(S):
            return gp.banded_nn1_tpu.__wrapped__(query, support, support_valid,
                                                 query_valid)
        return nearest(query, support, support_valid, band=band,
                       query_valid=query_valid, **kw)

    monkeypatch.setattr(jpyr, "radius_knn", tpu_radius_knn)
    monkeypatch.setattr(jpyr, "nearest", tpu_nearest)


def _tpu_extract_patches(key, pts, pts_valid, kpts, des_r, patch_sample):
    """The TPU branch of ``patch_embedder.py:56-68`` (on the CPU JAX would
    take ``ball_sample``, a different function)."""
    gathered, valid = gp.ball_sample_points_tpu.__wrapped__(
        key, kpts, pts, pts_valid, float(des_r), patch_sample)
    patches = jnp.where(valid[..., None], gathered, kpts[:, None, :])
    return patches.at[:, -1, :].set(kpts)


def _run_both(monkeypatch, jcfg, tcfg, raw, tgt):
    """register_pair of both packages on one pair: same inputs, weights and
    draws; returns ((res, inter) of the port, (res, inter) of JAX)."""
    monkeypatch.setattr(gp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jpe, "fused_point_features", _fused_kernel_semantics)
    if not jcfg.static.fused_desc:
        monkeypatch.setattr(jpe, "extract_patches", _tpu_extract_patches)
    _tpu_dispatch(monkeypatch)
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
    return (res, inter), (res_j, inter_j)


def _assert_tables_equal(pt, pj):
    """Pyramid tables equal: upsample indices exactly; neighbour and pool
    lists as sets where valid (fp32 ties may swap the order)."""
    for lvl in range(2):
        np.testing.assert_array_equal(pt.upsamples[lvl].numpy(),
                                      np.asarray(pj.upsamples[lvl]))
        np.testing.assert_array_equal(pt.upsample_valid[lvl].numpy(),
                                      np.asarray(pj.upsample_valid[lvl]))
    for got, want, got_v, want_v in (
            list(zip(pt.neighbors, pj.neighbors, pt.neighbor_valid,
                     pj.neighbor_valid))
            + list(zip(pt.pools, pj.pools, pt.pool_valid, pj.pool_valid))):
        v = np.asarray(want_v)
        np.testing.assert_array_equal(got_v.numpy(), v)
        np.testing.assert_array_equal(
            np.sort(np.where(v, got.numpy(), -1), -1),
            np.sort(np.where(v, np.asarray(want), -1), -1))


def test_register_pair_matches_jax(monkeypatch):
    _matches_jax(monkeypatch, jconfig.tiny_cfg(), tconfig.tiny_cfg())


def test_register_pair_sampled_front_matches_jax(monkeypatch):
    """``fused_desc = False``: the reference's sampled descriptor front
    (stacked patches through ``ball_sample_points``, ``delta @ R``, the
    sampled SPT, the network on the sampled patches), with the tolerances
    of the fused front."""
    off = lambda c: c.replace(static=dataclasses.replace(c.static,
                                                         fused_desc=False))
    _matches_jax(monkeypatch, off(jconfig.tiny_cfg()), off(tconfig.tiny_cfg()))


def _matches_jax(monkeypatch, jcfg, tcfg):
    # a small shift keeps matched keypoints close under random weights, so
    # RANSAC and IRLS find inliers and the pose comparison is not trivial
    raw = _surface(900, 0)
    tgt = raw + np.float32([0.02, -0.01, 0.015])
    (res, inter), (res_j, inter_j) = _run_both(monkeypatch, jcfg, tcfg, raw, tgt)

    _assert_tables_equal(inter["pyramid"], inter_j["pyramid"])
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


def _banded_plan(mod):
    c = mod.tiny_cfg()
    return c.replace(static=dataclasses.replace(
        c.static, points_l0=4096, points_l1=2048, points_l2=512,
        raw_points=4096, knn_band=512))


def test_register_pair_banded_matches_jax(monkeypatch):
    """A plan where the band is live: the level-0 and level-1 kNN, both
    pools and the l0 -> l1 upsample take the banded kernels (level 0 has
    32 grid rows against a 16-row window), level 2 the exact searches."""
    jcfg, tcfg = _banded_plan(jconfig), _banded_plan(tconfig)
    assert [neighbors.knn_route(S, 512) for S in (4096, 2048, 512)] == [
        "banded", "banded", "dense"]
    raw = _surface(4000, 1, extent=1.0)
    tgt = raw + np.float32([0.02, -0.01, 0.015])
    (res, inter), (res_j, inter_j) = _run_both(monkeypatch, jcfg, tcfg, raw, tgt)
    pt = inter["pyramid"]
    assert int(pt.masks[0][0].sum()) > 2048
    _assert_tables_equal(pt, inter_j["pyramid"])
    np.testing.assert_array_equal(inter["kidx"].numpy(), np.asarray(inter_j["kidx"]))
    assert res.kpt_valid.any()
    assert int(res.num_mutual) == int(res_j.num_mutual) > 0
    assert int(res.num_inliers) == int(res_j.num_inliers)
    np.testing.assert_allclose(res.pose.numpy(), np.asarray(res_j.pose),
                               rtol=1e-3, atol=1e-3)


def test_register_pair_kitti_matches_jax(monkeypatch):
    """The KITTI preset at the tiny plan: identity patch frames, no IRLS
    (pose_refine off), the LiDAR voxel sizes; a surface ten times the size
    of the 3DMatch one."""
    jcfg = jconfig.shrink_static(jconfig.kitti_cfg())
    tcfg = tconfig.shrink_static(tconfig.kitti_cfg())
    assert tcfg == tconfig.shrink_static(tconfig.make_cfg("KITTI"))
    assert not tcfg.test.pose_refine and tcfg.data.dataset == "KITTI"
    raw = _surface(900, 2, extent=6.0)
    tgt = raw + np.float32([0.2, -0.1, 0.15])
    (res, inter), (res_j, inter_j) = _run_both(monkeypatch, jcfg, tcfg, raw, tgt)
    _assert_tables_equal(inter["pyramid"], inter_j["pyramid"])
    np.testing.assert_array_equal(inter["kidx"].numpy(), np.asarray(inter_j["kidx"]))
    assert res.kpt_valid.any()
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), inter["s_R"].shape)
    np.testing.assert_array_equal(inter["s_R"].numpy(), eye)
    assert int(res.num_mutual) == int(res_j.num_mutual) > 0
    assert int(res.num_inliers) == int(res_j.num_inliers)
    np.testing.assert_allclose(res.pose.numpy(), np.asarray(res_j.pose),
                               rtol=1e-3, atol=1e-3)


def test_lidar_pair_matches_jax():
    """The port's KITTI-like LiDAR pair is the JAX package's, array for
    array, at the full KITTI plan (bench.py's seed)."""
    from buffer_tpu.data.synthetic import make_lidar_pair
    from buffer_tpu_torch.data.synthetic import lidar_pair
    want, T_want = make_lidar_pair(jconfig.kitti_cfg(), np.random.RandomState(13))
    got, T_got = lidar_pair(tconfig.kitti_cfg(), 13, device="cpu")
    np.testing.assert_array_equal(T_got, T_want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got.sds_mask[0].sum()) == 40000
