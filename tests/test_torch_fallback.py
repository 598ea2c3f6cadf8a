"""The banded search past the kernels' reach: the port's
``radius_knn_banded`` / ``nearest_banded`` (``ops/neighbors.py``) against
the JAX package's XLA functions of the same names
(``buffer_tpu/ops/neighbors.py:203-382``) on the CPU, where JAX itself takes
them, and a whole pair at the tiny plan with a restricting band, where
JAX's CPU pyramid takes them with no substitution.

The windows are the same integers.  Inside a window the port computes
exact fp32 distances and an exact top-k / argmin, where JAX ranks bf16
scores (a TPU workaround): the 1-NN agrees except at fp32 distance ties,
and a kNN set may differ only in entries within one bf16 spacing (2^-7
relative: two distances that round to one bf16 value rank by index in
JAX) of the k-th distance.  Also the searches without ``query_valid``,
where JAX takes no Pallas kernel: the fallbacks where the band restricts
(their windows scaled by S / Q), the exact searches where it does not.
Clouds are numpy-seeded Morton-sorted surfaces."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import buffer_tpu.config as jconfig
from buffer_tpu.data import preprocess as jpre
from buffer_tpu.ops import neighbors as jnbr

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.ops import neighbors

from test_torch_registration import (_assert_levels_equal, _run_both,
                                     _surface)

torch.set_num_threads(1)
BF16_RES = 2.0 ** -7     # one bf16 spacing, relative


def _t(a):
    return torch.from_numpy(np.array(a))


def _sorted_surface(rs, n):
    pts = rs.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    pts[:, 2] = 0.3 * np.sin(3 * pts[:, 0]) + 0.2 * np.cos(2 * pts[:, 1])
    return jpre.morton_sort(pts)


def _cloud(seed, S, ns, Q, nq):
    """Support [S, 3] with ns valid Morton-sorted ranks, and queries [Q, 3]
    with nq valid: a jittered sorted subsample of the support, or with
    Q == S the support itself."""
    rs = np.random.RandomState(seed)
    sup = np.zeros((S, 3), np.float32)
    sup[:ns] = _sorted_surface(rs, ns)
    sv = np.arange(S) < ns
    if Q == S:
        return sup, sup.copy(), sv, sv.copy()
    qry = np.zeros((Q, 3), np.float32)
    pick = np.sort(rs.choice(ns, nq, replace=False))
    qry[:nq] = sup[pick] + rs.normal(0, 0.01, (nq, 3)).astype(np.float32)
    return sup, qry, sv, np.arange(Q) < nq


CASES = {
    # past the 16-bit packed rank (S > 65536), a few query blocks
    "S70000": dict(S=70000, ns=66000, Q=2600, nq=2500, k=16, radius=0.05,
                   band=4096),
    "S70000-noradius": dict(S=70000, ns=69000, Q=1100, nq=1024, k=16,
                            radius=None, band=4096),
    # fewer than 16 grid rows (S = 1500): a self-search and a pool
    "S1500-self": dict(S=1500, ns=1400, Q=1500, nq=None, k=16, radius=None,
                       band=512),
    "S1500-pool": dict(S=1500, ns=1450, Q=700, nq=650, k=8, radius=0.15,
                       band=512),
}


def _d64(q, s, idx):
    """float64 squared distances of queries q [Q, 3] to s[idx] [Q, k]."""
    diff = q.astype(np.float64)[:, None] - s.astype(np.float64)[idx]
    return np.sum(diff * diff, -1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fallbacks_match_jax(case):
    c = CASES[case]
    S, Q, k, radius, band = c["S"], c["Q"], c["k"], c["radius"], c["band"]
    sup, qry, sv, qv = _cloud(7, S, c["ns"], Q, c["nq"])
    assert neighbors.knn_route(S, band) == "fallback"
    assert neighbors.nearest_route(S, band) == "fallback"
    j = lambda a: jnp.asarray(a)
    tb = lambda a: _t(a)[None]

    # the windows: the same integers as JAX's, kNN and 1-NN
    for qb, win in ((1024, 2 * band),
                    (512, min(-(-(2 * band - (-512 * S // Q)) // 256) * 256, S))):
        Qp = -(-Q // qb) * qb
        want = np.asarray(jnbr._band_starts(Qp, S, qb, win, j(qv), j(sv)))
        got = neighbors._band_starts(Qp, S, qb, win, tb(qv), tb(sv))
        assert got.dtype == torch.int32 and got.shape == (1, Qp // qb)
        np.testing.assert_array_equal(got[0].numpy(), want)

    # 1-NN: equal indices except at fp32 distance ties; d2 to 1e-6 of the
    # formula's scale
    want = jnbr.nearest_banded(j(qry), j(sup), j(sv), band, query_valid=j(qv))
    _assert_nn_within_ties(qry, sup, neighbors.nearest(
        tb(qry), tb(sup), tb(sv), band=band, query_valid=tb(qv)), want)

    # kNN: the contract of radius_knn, the valid sets up to bf16 ranking
    # near the k-th distance, every d2 its index's float64 distance
    want = jnbr.radius_knn_banded(j(qry), j(sup), j(sv), k, radius, band,
                                  query_valid=j(qv))
    _assert_knn_within_bf16(qry, sup, k, radius, neighbors.radius_knn(
        tb(qry), tb(sup), tb(sv), k, radius, band=band, query_valid=tb(qv)),
        want)


def _assert_nn_within_ties(qry, sup, got, want):
    """The port's 1-NN (d2, idx) [1, Q] against JAX's [Q]: equal indices
    except at fp32 distance ties, d2 to 1e-6 of the formula's scale."""
    jd, ji = (np.asarray(a) for a in want)
    d, i = (a[0].numpy() for a in got)
    assert i.dtype == np.int32
    scale = float(np.max(np.sum(qry.astype(np.float64) ** 2, -1)))
    for q in np.nonzero(i != ji)[0]:
        a, b = _d64(qry[q:q + 1], sup, np.array([[i[q], ji[q]]]))[0]
        assert abs(a - b) <= 1e-6 * scale, (q, a, b)
    np.testing.assert_allclose(d, jd, rtol=1e-6, atol=1e-6 * scale)


def _assert_knn_within_bf16(qry, sup, k, radius, got, want):
    """The port's kNN (d2, idx, valid) [1, Q, k] against JAX's [Q, k]:
    :func:`radius_knn`'s contract, the valid counts equal, the valid sets
    equal up to entries within one bf16 spacing of the k-th distance, every
    valid d2 within 1e-5 of its index's float64 distance."""
    jd, ji, jv = (np.asarray(a) for a in want)
    d, i, v = (a[0].numpy() for a in got)
    Q = qry.shape[0]
    assert i.dtype == np.int32 and d.shape == (Q, k)
    assert (d[~v] == neighbors.BIG).all() and (i[~v] == 0).all()
    assert (np.diff(d, axis=-1) >= 0).all()
    d64 = _d64(qry, sup, i)
    np.testing.assert_allclose(d[v], d64[v], rtol=0, atol=1e-5)
    assert (v.sum(-1) == jv.sum(-1)).all()
    n_diff = 0
    for q in range(Q):
        g, w = set(i[q][v[q]]), set(ji[q][jv[q]])
        if g == w:
            continue
        kth = d64[q][v[q]].max()
        for s in g ^ w:
            ds = _d64(qry[q:q + 1], sup, np.array([[s]]))[0, 0]
            assert abs(ds - kth) <= BF16_RES * kth, (q, s, ds, kth)
        n_diff += 1
    assert n_diff <= Q // 2
    if radius is not None:
        assert (d[v] <= radius ** 2).all()


NO_MASK_CASES = {
    # a kernel-supported S (32 grid rows) under a restricting band: the
    # kernels with query_valid, the fallbacks without
    "restricting-S4096": dict(S=4096, ns=3900, Q=1500, nq=1400, k=16,
                              radius=0.12, band=512,
                              routes=("banded", "fallback", "fallback")),
    # a band whose window covers the grid (16 rows): the kNN kernel with
    # query_valid, the exact searches without
    "covering-S2048": dict(S=2048, ns=2000, Q=700, nq=600, k=8, radius=0.05,
                           band=1024, routes=("banded", "dense", "exact")),
    # past the kernels' 65536 ranks: the fallbacks, their windows scaled by
    # S / Q instead of the valid counts
    "S70000": dict(S=70000, ns=66000, Q=2600, nq=2500, k=16, radius=0.05,
                   band=4096, routes=("fallback", "fallback", "fallback")),
}


@pytest.mark.parametrize("case", sorted(NO_MASK_CASES))
def test_searches_without_query_valid_match_jax(case):
    """``radius_knn(band=...)`` and ``nearest(band=...)`` without
    ``query_valid`` against JAX's, which takes no Pallas kernel without the
    mask (``buffer_tpu/ops/neighbors.py:98, 117-126, 402-411``): the
    fallbacks where the band restricts, the exact searches where it does
    not; within the allowances above."""
    c = NO_MASK_CASES[case]
    S, Q, k, radius, band = c["S"], c["Q"], c["k"], c["radius"], c["band"]
    masked, knn, nn = c["routes"]
    assert neighbors.knn_route(S, band) == masked
    assert neighbors.knn_route(S, band, masked=False) == knn
    assert neighbors.nearest_route(S, band, masked=False) == nn
    sup, qry, sv, _ = _cloud(7, S, c["ns"], Q, c["nq"])
    j = lambda a: jnp.asarray(a)
    tb = lambda a: _t(a)[None]
    Qp = -(-Q // 1024) * 1024
    np.testing.assert_array_equal(
        neighbors._band_starts(Qp, S, 1024, 2 * band).numpy(),
        np.asarray(jnbr._band_starts(Qp, S, 1024, 2 * band)))
    _assert_nn_within_ties(qry, sup, neighbors.nearest(
        tb(qry), tb(sup), tb(sv), band=band), jnbr.nearest(
        j(qry), j(sup), j(sv), band=band))
    _assert_knn_within_bf16(qry, sup, k, radius, neighbors.radius_knn(
        tb(qry), tb(sup), tb(sv), k, radius, band=band), jnbr.radius_knn(
        j(qry), j(sup), j(sv), k, radius, band=band))


def test_fallback_wide_window_groups_blocks(monkeypatch):
    """A search split into one block a group gives what one group gives:
    the groups bound the memory and nothing else."""
    sup, qry, sv, qv = _cloud(3, 70000, 66000, 3000, 2900)
    args = (_t(qry)[None].repeat(2, 1, 1), _t(sup)[None].repeat(2, 1, 1),
            _t(sv)[None].repeat(2, 1), 16, 0.05, 4096)
    kw = dict(query_valid=_t(qv)[None].repeat(2, 1))
    whole = neighbors.radius_knn_banded(*args, **kw)
    nn = neighbors.nearest_banded(*args[:3], 4096, **kw)
    monkeypatch.setattr(neighbors, "FIELD_ELEMS", 1)
    for a, b in zip(neighbors.radius_knn_banded(*args, **kw), whole):
        assert torch.equal(a, b)
    for a, b in zip(neighbors.nearest_banded(*args[:3], 4096, **kw), nn):
        assert torch.equal(a, b)
    assert torch.equal(whole[0][0], whole[0][1])


def _fallback_plan(mod):
    c = mod.tiny_cfg()
    return c.replace(static=dataclasses.replace(c.static, knn_band=64))


def _assert_tables_within_ties(pt, pj, r0):
    """The pyramid tables of the fallback plan: upsample indices equal
    except at float64 distance ties; neighbour and pool sets equal except
    entries within one bf16 spacing of the k-th distance (JAX ranks bf16
    scores) or, at level 0, of the radius (JAX's level-0 radius test reads
    its bf16 distances).  Returns the number of such rows."""
    rows = 0
    for lvl in range(2):
        got, want = pt.upsamples[lvl].numpy(), np.asarray(pj.upsamples[lvl])
        q, s = pt.points[lvl].numpy(), pt.points[lvl + 1].numpy()
        for b, n in np.argwhere(got != want):
            a, c = _d64(q[b, n:n + 1], s[b], np.array([[got[b, n], want[b, n]]]))[0]
            assert abs(a - c) <= 1e-6 * max(a, c, 1e-12), (lvl, b, n, a, c)
    tables = ([(pt.neighbors[l], pj.neighbors[l], pt.neighbor_valid[l],
                pj.neighbor_valid[l], pt.points[l], pt.points[l], l)
               for l in range(3)]
              + [(pt.pools[l], pj.pools[l], pt.pool_valid[l], pj.pool_valid[l],
                  pt.points[l + 1], pt.points[l], l) for l in range(2)])
    for got, want, gv, wv, q, s, lvl in tables:
        got, want, gv, wv = got.numpy(), np.asarray(want), gv.numpy(), np.asarray(wv)
        q, s = q.numpy(), s.numpy()
        for b in range(got.shape[0]):
            for n in range(got.shape[1]):
                g, w = set(got[b, n][gv[b, n]]), set(want[b, n][wv[b, n]])
                if g == w:
                    continue
                rows += 1
                d = _d64(q[b, n:n + 1], s[b], np.array([sorted(g | w)]))[0]
                dist = dict(zip(sorted(g | w), d))
                kth = max(dist[x] for x in g) if g else 0.0
                for x in g ^ w:
                    near_kth = abs(dist[x] - kth) <= BF16_RES * kth
                    near_r = (lvl == 0 and abs(dist[x] - r0 * r0)
                              <= BF16_RES * r0 * r0)
                    assert near_kth or near_r, (lvl, b, n, x, dist[x], kth)
    return rows


def test_register_pair_through_the_fallback_matches_jax(monkeypatch):
    """The tiny plan with ``knn_band = 64``: every level has fewer than 16
    grid rows, so the level-0 and level-1 kNN, both pools and the l0 -> l1
    upsample take the fallbacks in both packages (JAX's own CPU dispatch,
    ``buffer_tpu/ops/neighbors.py:117-120, 402-411``).  The tables agree up
    to the ties above; then the pair runs on JAX's tables and the pose is
    held to 1e-4."""
    jcfg, tcfg = _fallback_plan(jconfig), _fallback_plan(tconfig)
    st = tcfg.static
    assert [neighbors.knn_route(S, 64) for S in
            (st.points_l0, st.points_l1, st.points_l2)] == [
        "fallback", "fallback", "dense"]
    assert neighbors.nearest_route(st.points_l1, 64) == "fallback"
    assert neighbors.nearest_route(st.points_l2, 64) == "exact"
    raw = _surface(900, 0)
    tgt = raw + np.float32([0.02, -0.01, 0.015])
    (res, inter), (res_j, inter_j), (res_p, inter_p) = _run_both(
        monkeypatch, jcfg, tcfg, raw, tgt, pinned=True)
    pt, pj = inter["pyramid"], inter_j["pyramid"]
    _assert_levels_equal(pt, pj)
    r0 = tcfg.data.voxel_size_0 * tcfg.point.conv_radius
    _assert_tables_within_ties(pt, pj, r0)
    assert res.kpt_valid.any() and int(res.num_mutual) > 0
    assert torch.isfinite(res.pose).all()
    # on JAX's tables the rest of the pair is JAX's
    np.testing.assert_array_equal(inter_p["kidx"].numpy(),
                                  np.asarray(inter_j["kidx"]))
    assert int(res_p.num_mutual) == int(res_j.num_mutual) > 0
    assert int(res_p.num_inliers) == int(res_j.num_inliers)
    np.testing.assert_allclose(res_p.pose.numpy(), np.asarray(res_j.pose),
                               rtol=1e-4, atol=1e-4)
