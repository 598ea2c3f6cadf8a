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
from buffer_tpu_torch.models.point_learner import Pyramid
from buffer_tpu_torch.pipeline import registration as tregistration
from buffer_tpu_torch.pipeline.pyramid import build_pyramid_and_normals
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


def _inputs_both(jcfg, tcfg, raw, tgt, device_levels=False):
    """prepare_pair of both packages from one seed (equal arrays); with
    ``device_levels`` the host-built levels are dropped, so that each
    pyramid builds them on its device."""
    j_inputs = jpre.prepare_pair(jcfg, raw.copy(), tgt.copy(),
                                 rs=np.random.RandomState(3),
                                 already_downsampled=True)
    t_inputs = prepare_pair(tcfg, raw.copy(), tgt.copy(),
                            rs=np.random.RandomState(3),
                            already_downsampled=True, device="cpu")
    for g, w in zip(t_inputs, j_inputs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if device_levels:
        none = dict(lvl1=None, lvl1_mask=None, lvl2=None, lvl2_mask=None)
        j_inputs, t_inputs = j_inputs._replace(**none), t_inputs._replace(**none)
    return j_inputs, t_inputs


def _run_both(monkeypatch, jcfg, tcfg, raw, tgt, device_levels=False,
              pinned=False):
    """register_pair of both packages on one pair: same inputs, weights and
    draws; returns ((res, inter) of the port, (res, inter) of JAX), and with
    ``pinned`` also (res, inter) of the port run on JAX's pyramid."""
    monkeypatch.setattr(gp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jpe, "fused_point_features", _fused_kernel_semantics)
    if not jcfg.static.fused_desc:
        monkeypatch.setattr(jpe, "extract_patches", _tpu_extract_patches)
    _tpu_dispatch(monkeypatch)
    j_inputs, t_inputs = _inputs_both(jcfg, tcfg, raw, tgt, device_levels)

    jm = JModel(jcfg)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0))
    model = BufferModel(tcfg)
    model.load_state_dict({k: torch.tensor(v) for k, v in variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)).items()})

    key = jax.random.PRNGKey(7)
    res_j, inter_j = jax.jit(lambda v, i, k: j_register_pair(
        jm, v, i, k, return_intermediates=True))(variables, j_inputs, key)
    run = lambda: register_pair(model, t_inputs, _jax_draws(key, jcfg),
                                device="cpu", return_intermediates=True)
    res, inter = run()
    if not pinned:
        return (res, inter), (res_j, inter_j)
    pj = inter_j["pyramid"]
    conv = lambda x: (tuple(torch.from_numpy(np.array(a)) for a in x)
                      if isinstance(x, tuple) else torch.from_numpy(np.array(x)))
    pyr = Pyramid(*(conv(getattr(pj, f)) for f in Pyramid._fields))
    with monkeypatch.context() as m:
        m.setattr(tregistration, "build_pyramid_and_normals",
                  lambda *a, **k: pyr)
        return (res, inter), (res_j, inter_j), run()


def _radius0(cfg):
    return cfg.data.voxel_size_0 * cfg.point.conv_radius


def _assert_levels_equal(pt, pj):
    """The pyramid's points and masks of every level equal (the device
    levels bit for bit: both sum each voxel in sorted order in fp32)."""
    for lvl in range(3):
        np.testing.assert_array_equal(pt.masks[lvl].numpy(),
                                      np.asarray(pj.masks[lvl]))
        np.testing.assert_array_equal(pt.points[lvl].numpy(),
                                      np.asarray(pj.points[lvl]))


def _assert_tables_equal(pt, pj, r0=None):
    """Pyramid tables equal: upsample indices exactly; neighbour and pool
    lists as sets where valid (fp32 ties may swap the order).  With the
    level-0 radius ``r0``, an entry valid in one package only is allowed
    where its float64 distance lies within 1e-5 relative of the radius: the
    in-radius test within rounding of the radius (ROADMAP section 3); the
    sets are compared without such entries.  Returns their number."""
    for lvl in range(2):
        np.testing.assert_array_equal(pt.upsamples[lvl].numpy(),
                                      np.asarray(pj.upsamples[lvl]))
        np.testing.assert_array_equal(pt.upsample_valid[lvl].numpy(),
                                      np.asarray(pj.upsample_valid[lvl]))
    tables = ([(pt.neighbors[l], pj.neighbors[l], pt.neighbor_valid[l],
                pj.neighbor_valid[l], pt.points[l], pt.points[l], l)
               for l in range(3)]
              + [(pt.pools[l], pj.pools[l], pt.pool_valid[l], pj.pool_valid[l],
                  pt.points[l + 1], pt.points[l], l) for l in range(2)])
    flips = 0
    for got, want, got_v, want_v, q, s, lvl in tables:
        got, want = got.numpy(), np.asarray(want)
        gv, v = got_v.numpy(), np.asarray(want_v)
        if r0 is not None and (gv != v).any():
            r2 = (r0 * 2 ** lvl) ** 2
            for b, i, k in np.argwhere(gv != v):
                j = got[b, i, k] if gv[b, i, k] else want[b, i, k]
                d2 = np.sum((q[b, i].double().numpy()
                             - s[b, j].double().numpy()) ** 2)
                assert abs(d2 - r2) <= 1e-5 * r2, (lvl, b, i, k, d2, r2)
                flips += 1
            both = gv & v
            gv, v = both, both
        np.testing.assert_array_equal(gv, v)
        np.testing.assert_array_equal(np.sort(np.where(v, got, -1), -1),
                                      np.sort(np.where(v, want, -1), -1))
    return flips


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


def _matches_jax(monkeypatch, jcfg, tcfg, device_levels=False):
    # a small shift keeps matched keypoints close under random weights, so
    # RANSAC and IRLS find inliers and the pose comparison is not trivial
    raw = _surface(900, 0)
    tgt = raw + np.float32([0.02, -0.01, 0.015])
    runs = _run_both(monkeypatch, jcfg, tcfg, raw, tgt, device_levels,
                     pinned=device_levels)
    (res, inter), (res_j, inter_j) = runs[:2]

    _assert_levels_equal(inter["pyramid"], inter_j["pyramid"])
    if _assert_tables_equal(inter["pyramid"], inter_j["pyramid"],
                            _radius0(tcfg) if device_levels else None):
        # a neighbour at the radius in one package only moves the saliency
        # and axes of every point (and so the descriptors): from the pyramid
        # on, the port is then held on JAX's tables
        res, inter = runs[2]
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


def _band0(mod):
    c = mod.tiny_cfg()
    return c.replace(static=dataclasses.replace(c.static, knn_band=0))


def _banded_plan(mod):
    c = mod.tiny_cfg()
    return c.replace(static=dataclasses.replace(
        c.static, points_l0=4096, points_l1=2048, points_l2=512,
        raw_points=4096, knn_band=512))


def test_register_pair_banded_matches_jax(monkeypatch):
    """A plan where the band is live: the level-0 and level-1 kNN, both
    pools and the l0 -> l1 upsample take the banded kernels (level 0 has
    32 grid rows against a 16-row window), level 2 the exact searches."""
    _banded_matches_jax(monkeypatch)


def _banded_matches_jax(monkeypatch, device_levels=False):
    jcfg, tcfg = _banded_plan(jconfig), _banded_plan(tconfig)
    assert [neighbors.knn_route(S, 512) for S in (4096, 2048, 512)] == [
        "banded", "banded", "dense"]
    raw = _surface(4000, 1, extent=1.0)
    tgt = raw + np.float32([0.02, -0.01, 0.015])
    (res, inter), (res_j, inter_j) = _run_both(monkeypatch, jcfg, tcfg, raw, tgt,
                                               device_levels)
    pt = inter["pyramid"]
    assert int(pt.masks[0][0].sum()) > 2048
    _assert_levels_equal(pt, inter_j["pyramid"])
    _assert_tables_equal(pt, inter_j["pyramid"],
                         _radius0(tcfg) if device_levels else None)
    np.testing.assert_array_equal(inter["kidx"].numpy(), np.asarray(inter_j["kidx"]))
    assert res.kpt_valid.any()
    assert int(res.num_mutual) == int(res_j.num_mutual) > 0
    assert int(res.num_inliers) == int(res_j.num_inliers)
    np.testing.assert_allclose(res.pose.numpy(), np.asarray(res_j.pose),
                               rtol=1e-3, atol=1e-3)


def test_register_pair_device_levels_matches_jax(monkeypatch):
    """``lvl1 = None``: both pyramids voxel-subsample levels 1 and 2 on the
    device, in voxel-key order, at the tiny plan with the exact searches
    (``knn_band = 0``); the tolerances of the host-levels test."""
    _matches_jax(monkeypatch, _band0(jconfig), _band0(tconfig),
                 device_levels=True)


def test_register_pair_device_levels_banded_matches_jax(monkeypatch):
    """``lvl1 = None`` on the banded plan: the banded searches run over the
    device levels' voxel-key rank order, as in the reference."""
    _banded_matches_jax(monkeypatch, device_levels=True)


@pytest.mark.parametrize("plan", ["knn_band=0", "banded"])
def test_device_levels_pyramid_matches_jax(monkeypatch, plan):
    """``build_pyramid_and_normals(levels=None)`` of both packages on one
    pair: the levels bit for bit, the tables as sets (the host-levels
    allowances), the normals to fp32 reordering; the device levels hold the
    host levels' points (``prepare_pair``) within 1e-5 as sets."""
    if plan == "banded":
        jcfg, tcfg = _banded_plan(jconfig), _banded_plan(tconfig)
        raw = _surface(4000, 1, extent=1.0)
    else:
        jcfg, tcfg = _band0(jconfig), _band0(tconfig)
        raw = _surface(420, 0, extent=0.4)
    monkeypatch.setattr(gp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    _tpu_dispatch(monkeypatch)
    j_in, t_in = _inputs_both(jcfg, tcfg, raw, raw + np.float32(0.02))
    want = jax.jit(lambda p, m: jpyr.build_pyramid_and_normals(jcfg, p, m))(
        j_in.sds, j_in.sds_mask)
    got = build_pyramid_and_normals(tcfg, t_in.sds, t_in.sds_mask)
    _assert_levels_equal(got, want)
    _assert_tables_equal(got, want, _radius0(tcfg))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features),
                               rtol=1e-4, atol=1e-5)
    host = ((t_in.lvl1, t_in.lvl1_mask), (t_in.lvl2, t_in.lvl2_mask))
    for lvl, (pts, msk) in enumerate(host, start=1):
        # no level overflows its plan, so both hold every voxel
        assert not msk.all(-1).any()
        for b in range(2):
            dev_pts = got.points[lvl][b][got.masks[lvl][b]].numpy()
            host_pts = pts[b][msk[b]].numpy()
            assert len(dev_pts) == len(host_pts) > 0
            order = lambda a: a[np.lexsort(np.round(a, 4).T[::-1])]
            np.testing.assert_allclose(order(dev_pts), order(host_pts),
                                       rtol=0, atol=1e-5)


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


@pytest.mark.parametrize("name", ["3DLoMatch", "ThreeD2ETH", "ThreeD2KITTI",
                                  "KITTI2ThreeD", "KITTI2ETH"])
def test_register_pair_presets_match_jax(monkeypatch, name):
    """The five other presets at ``shrink_static``: the Ref network's
    neighbourhood scaling by ``test.scale`` (5 for ThreeD2ETH, 0.1167 for
    KITTI2ThreeD), ``keypts_th = 0`` with IRLS at the 3DLoMatch threshold
    (KITTI2ThreeD), the ETH and KITTI patch frames; each on a surface
    scaled to its voxel size, with the tolerances of the 3DMatch test."""
    jcfg = jconfig.shrink_static(jconfig.make_cfg(name))
    tcfg = tconfig.shrink_static(tconfig.make_cfg(name))
    scale = tcfg.data.voxel_size_0 / 0.035
    raw = _surface(900, 3, extent=0.6 * scale)
    tgt = raw + np.float32([0.02, -0.01, 0.015]) * np.float32(scale)
    (res, inter), (res_j, inter_j) = _run_both(monkeypatch, jcfg, tcfg, raw, tgt)
    _assert_tables_equal(inter["pyramid"], inter_j["pyramid"])
    np.testing.assert_allclose(inter["score"].numpy(), np.asarray(inter_j["score"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(inter["kidx"].numpy(), np.asarray(inter_j["kidx"]))
    np.testing.assert_array_equal(res.kpt_valid.numpy(), np.asarray(res_j.kpt_valid))
    assert res.kpt_valid.any()
    for field in ("s_des", "t_des"):
        err = np.abs(inter[field].numpy() - np.asarray(inter_j[field])).max(-1)
        assert (err > 1e-4).mean() <= 0.05 and err.max() < 0.05, (field, err.max())
    assert int(res.num_mutual) == int(res_j.num_mutual) > 0
    np.testing.assert_array_equal(inter["vote_inliers"].numpy(),
                                  np.asarray(inter_j["vote_inliers"]))
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
