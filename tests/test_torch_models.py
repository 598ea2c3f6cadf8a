"""The port's learned modules and pose tail against the JAX package on the
CPU, at the tiny plan.  Weights come from the JAX package's
``BufferModel(tiny_cfg()).init`` through ``variables_to_state_dict``;
inputs from numpy seeds.  Tolerances are fp32 rounding of the same
arithmetic done in another order (matmul blocking, reductions)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import buffer_tpu.config as jconfig
from buffer_tpu.compat.torch_convert import convert_state_dict
from buffer_tpu.data import preprocess as jpre
from buffer_tpu.models.composite import BufferModel as JModel
from buffer_tpu.pipeline import matching as jmatching, ransac as jransac
from buffer_tpu.pipeline import refine as jrefine
from buffer_tpu.pipeline.pyramid import build_pyramid_and_normals as j_pyramid

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.compat.from_jax import variables_to_state_dict
from buffer_tpu_torch.kernels import pose_cuda, sites
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.models.patch_embedder import fold_point_mlp
from buffer_tpu_torch.models.point_learner import Pyramid
from buffer_tpu_torch.pipeline import matching, ransac, refine
from buffer_tpu_torch.pipeline.pyramid import build_pyramid_and_normals

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def weights():
    jm = JModel(jconfig.tiny_cfg())
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    model = BufferModel(tconfig.tiny_cfg())
    sd = variables_to_state_dict(variables)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return jm, variables, model, sd


@pytest.fixture(scope="module")
def pair():
    rs = np.random.RandomState(0)
    raw = rs.uniform(-0.6, 0.6, (700, 3)).astype(np.float32)
    raw[:, 2] = (0.25 * np.sin(4 * raw[:, 0]) + 0.2 * np.cos(3 * raw[:, 1])
                 + 0.08 * np.sin(11 * raw[:, 0] * raw[:, 1]) + 1.5)
    tgt = raw @ np.float32([[0.96, -0.28, 0], [0.28, 0.96, 0], [0, 0, 1]]).T
    return jpre.prepare_pair(jconfig.tiny_cfg(), raw, tgt.astype(np.float32),
                             rs=np.random.RandomState(1))


def test_weights_round_trip(weights):
    """variables -> state dict -> convert_state_dict gives back the same
    variables, and the port's model holds every key."""
    _, variables, model, sd = weights
    params, stats = convert_state_dict(sd)
    for stage in variables:
        for name, tree in (("params", params), ("batch_stats", stats)):
            want = jax.tree_util.tree_leaves_with_path(variables[stage].get(name, {}))
            got = dict(jax.tree_util.tree_leaves_with_path(tree[stage]))
            assert len(got) == len(want)
            for path, w in want:
                np.testing.assert_array_equal(got[path], w)
    assert set(model.state_dict()) == set(sd)


@pytest.fixture(scope="module")
def jpyr(pair):
    levels = (pair.lvl1, pair.lvl1_mask, pair.lvl2, pair.lvl2_mask)
    return jax.jit(lambda *a: j_pyramid(jconfig.tiny_cfg(), a[0], a[1],
                                        levels=a[2:]))(
        pair.sds, pair.sds_mask, *levels)


def _sorted_rows(idx, valid):
    return np.sort(np.where(valid, idx, -1), axis=-1)


def _pyramid_to_torch(p) -> Pyramid:
    conv = lambda x: tuple(_t(a) for a in x) if isinstance(x, tuple) else _t(x)
    return Pyramid(*(conv(getattr(p, f)) for f in Pyramid._fields))


def test_pyramid_tables_match(pair, jpyr):
    levels = (pair.lvl1, pair.lvl1_mask, pair.lvl2, pair.lvl2_mask)
    want = jpyr
    got = build_pyramid_and_normals(
        tconfig.tiny_cfg(), _t(pair.sds), _t(pair.sds_mask),
        tuple(_t(a) for a in levels))
    for field in ("points", "masks", "neighbor_valid", "pool_valid",
                  "upsample_valid", "upsamples"):
        for lvl, (g, w) in enumerate(zip(getattr(got, field), getattr(want, field))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{field}[{lvl}]")
    # neighbour and pool lists hold the same sets; neighbours whose fp32
    # distances tie to rounding (voxel-grid clouds have many) may swap
    # places in the sorted order, which the conv's means and maxima ignore
    for field, vfield in (("neighbors", "neighbor_valid"), ("pools", "pool_valid")):
        for lvl, (g, w, v) in enumerate(zip(getattr(got, field), getattr(want, field),
                                            getattr(want, vfield))):
            v = np.asarray(v)
            np.testing.assert_array_equal(_sorted_rows(g.numpy(), v),
                                          _sorted_rows(np.asarray(w), v),
                                          err_msg=f"{field}[{lvl}]")
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features),
                               rtol=1e-4, atol=1e-4)


def test_efcnn_detnet_match(weights, jpyr):
    """Axis, eps and saliency on the same (JAX-built) pyramid."""
    jm, variables, model, _ = weights

    @jax.jit
    def heads(v, p):
        axis, eps, branch = jm.Ref.apply(v["Ref"], p)
        return axis, eps, jm.Keypt.apply(v["Keypt"], p, branch)

    axis_j, eps_j, score_j = heads(variables, jpyr)
    pyr = _pyramid_to_torch(jpyr)
    with torch.no_grad():
        axis, eps, tbranch = model.Ref(pyr)
        score = model.Keypt(pyr, tbranch)
    # the VN gate is continuous at its threshold, so fp32 reordering only
    # moves values at rounding level through the five blocks
    np.testing.assert_allclose(axis.numpy(), np.asarray(axis_j), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(eps.numpy(), np.asarray(eps_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(score.numpy(), np.asarray(score_j), rtol=1e-4, atol=1e-5)


def test_minispinnet_and_fold_match(weights):
    jm, variables, model, _ = weights
    rs = np.random.RandomState(2)
    pooled = np.maximum(rs.randn(12, 3, 7, 20, 16), 0).astype(np.float32)
    desc_j, equi_j = jm.Desc.apply(variables["Desc"], pooled=jnp.asarray(pooled))
    with torch.no_grad():
        desc, equi = model.Desc(_t(pooled))
        W_all, b_eff, f0 = fold_point_mlp(model.Desc, 20)
    np.testing.assert_allclose(desc.numpy(), np.asarray(desc_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(equi.numpy(), np.asarray(equi_j), rtol=1e-4, atol=1e-5)
    # the reference's fold (patch_embedder.py:276-294)
    p, s = variables["Desc"]["params"], variables["Desc"]["batch_stats"]
    scale = p["pnt_bn"]["weight"] / np.sqrt(s["pnt_bn"]["var"] + 1e-5)
    W_eff = p["pnt_conv"]["kernel"] * scale[None, :]
    b_want = (p["pnt_conv"]["bias"] - s["pnt_bn"]["mean"]) * scale + p["pnt_bn"]["bias"]
    from buffer_tpu.core.gridmath import azimuth_derotations
    W_want = np.einsum("aji,jc->aic", azimuth_derotations(20), W_eff)
    np.testing.assert_allclose(W_all.numpy(), W_want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b_eff.numpy(), b_want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f0.numpy(), np.maximum(b_want, 0), rtol=1e-5, atol=1e-6)


def test_cost_volume_matches(weights):
    jm, variables, model, _ = weights
    rs = np.random.RandomState(3)
    d1, d2 = (rs.randn(2, 10, 5, 20, 32).astype(np.float32))
    want = jm.Inlier.apply(variables["Inlier"], jnp.asarray(d1), jnp.asarray(d2))
    with torch.no_grad():
        got = model.Inlier(_t(d1), _t(d2))
    # reference factors the first conv through the circulant structure; the
    # port convolves the roll stack directly: same sums, other order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("iters", [10, 20])
def test_matching_ransac_irls_match(iters):
    """Mutual matching, hypotheses and voting, RANSAC with JAX's own Gumbel
    draws, and IRLS on a noisy rigid correspondence set at the base and the
    low-match budget's rounds (10, 20); on CPU tensors the pose solver's
    wrappers are their plain versions, so RANSAC's and IRLS's results are
    also the plain versions' bit for bit."""
    rs = np.random.RandomState(4)
    K, H = 64, 128
    des = rs.randn(2, K, 32).astype(np.float32)
    des[1, :40] = des[0, :40] + 0.05 * rs.randn(40, 32)
    des /= np.linalg.norm(des, axis=-1, keepdims=True)
    valid = np.ones((2, K), bool)
    valid[1, -3:] = False
    mj = jmatching.mutual_matching(*map(jnp.asarray, (des[0], des[1], valid[0], valid[1])))
    m = matching.mutual_matching(*map(_t, (des[0], des[1], valid[0], valid[1])))
    for g, w in zip(m, mj):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    src = rs.randn(K, 3).astype(np.float32)
    Rg = np.float32([[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1]])
    tgt = (src @ Rg.T + np.float32([0.1, 0.2, -0.3])
           + 0.005 * rs.randn(K, 3)).astype(np.float32)
    tgt[50:] += rs.randn(14, 3).astype(np.float32)
    q, _ = np.linalg.qr(rs.randn(2, K, 3, 3))
    sR, tR = q.astype(np.float32)
    ind = (rs.rand(K) * 20).astype(np.float32)
    Rh_j, th_j = jmatching.pose_hypotheses(*map(jnp.asarray, (src, tgt, sR, tR, ind)), 20)
    Rh, th = matching.pose_hypotheses(*map(_t, (src, tgt, sR, tR, ind)), 20)
    np.testing.assert_allclose(Rh.numpy(), np.asarray(Rh_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(th_j), rtol=1e-5, atol=1e-5)
    mutual = np.asarray(mj.mutual)
    best_j, inl_j = jmatching.vote_hypotheses(jnp.asarray(src), jnp.asarray(tgt), Rh_j,
                                              th_j, jnp.asarray(mutual), 20, 1 / 3)
    best, inl = matching.vote_hypotheses(_t(src), _t(tgt), Rh, th, _t(mutual), 20, 1 / 3)
    assert int(best) == int(best_j)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_j))

    corr = np.ones(K, bool)
    corr[::7] = False
    key = jax.random.PRNGKey(5)
    logits = jnp.where(jnp.asarray(corr), 0.0, -jnp.inf)
    gumbel = np.asarray(jax.random.gumbel(key, (H, 3, K)))
    np.testing.assert_array_equal(
        ransac.sample_triplets(_t(corr), _t(gumbel)).numpy(),
        np.asarray(jax.random.categorical(key, logits, shape=(H, 3))))
    pose_j, rinl_j = jransac.ransac_pose(key, jnp.asarray(src), jnp.asarray(tgt),
                                         jnp.asarray(corr), 0.1, 0.8, H)
    pose, rinl = ransac.ransac_pose(_t(gumbel), _t(src), _t(tgt), _t(corr), 0.1, 0.8)
    np.testing.assert_array_equal(rinl.numpy(), np.asarray(rinl_j))
    np.testing.assert_allclose(pose.numpy(), np.asarray(pose_j), rtol=1e-4, atol=1e-4)
    with sites.plain_versions():
        pose_p, rinl_p = ransac.ransac_pose(_t(gumbel), _t(src), _t(tgt), _t(corr),
                                            0.1, 0.8)
    assert torch.equal(pose, pose_p) and torch.equal(rinl, rinl_p)
    ref_j = jrefine.post_refinement(pose_j, jnp.asarray(src), jnp.asarray(tgt),
                                    jnp.asarray(corr), 0.1, iters=iters)
    ref = refine.post_refinement(pose, _t(src), _t(tgt), _t(corr), 0.1, iters=iters)
    np.testing.assert_allclose(ref.numpy(), np.asarray(ref_j), rtol=1e-4, atol=1e-4)
    plain = pose_cuda.irls_plain(pose, _t(src), _t(tgt), _t(corr), 0.1, iters)
    assert torch.equal(ref, plain)
    np.testing.assert_allclose(ref.numpy()[:3, :3], Rg, atol=1e-2)
