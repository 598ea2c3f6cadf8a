"""The port's rank-banded neighbour search and single-cloud FPS against the
JAX package's Pallas kernels in interpret mode (the kernels' own contract):
``banded_knn_tpu`` with its stage B ``topk_packed_tpu``, ``banded_nn1_tpu``
and ``fps_pallas``.  Plain versions and kernels share their key ordering,
so indices (where valid), validity and the truncated distances must be
exactly equal.  Also the dispatch of the pyramid's searches at the 3DMatch
and KITTI plans, and the CPU wrappers.  Clouds are numpy-seeded surfaces,
Morton-sorted by both packages' ``morton_sort`` (held equal)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import buffer_tpu.kernels.fps_pallas as fp
import buffer_tpu.kernels.geom_pallas as gp
from buffer_tpu.data import preprocess as jpre

from buffer_tpu_torch import config as tconfig
from buffer_tpu_torch.data import preprocess as tpre
from buffer_tpu_torch.kernels import cuda, knn_cuda
from buffer_tpu_torch.ops import neighbors, sampling

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    for mod in (gp, fp):
        monkeypatch.setattr(mod.pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _sorted_surface(rs, n):
    pts = rs.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    pts[:, 2] = 0.3 * np.sin(3 * pts[:, 0]) + 0.2 * np.cos(2 * pts[:, 1])
    out = tpre.morton_sort(pts)
    np.testing.assert_array_equal(out, jpre.morton_sort(pts))
    return out


def _clouds(seed, S, Q, n_valid_s, n_valid_q, hole=None):
    """B = 2 Morton-sorted clouds: support [2, S, 3] with n_valid_s valid
    ranks (the rest zero padding) and an optional invalid stretch, query
    [2, Q, 3] with n_valid_q: a jittered subsample of the support, or with
    Q == S the support itself (the level-0 self-search)."""
    rs = np.random.RandomState(seed)
    sup = np.zeros((2, S, 3), np.float32)
    qry = np.zeros((2, Q, 3), np.float32)
    sv = np.zeros((2, S), bool)
    qv = np.zeros((2, Q), bool)
    for b in range(2):
        ns = n_valid_s - 97 * b
        sup[b, :ns] = _sorted_surface(rs, ns)
        sv[b, :ns] = True
        if hole is not None:
            sv[b, hole[0]:hole[1]] = False
        if Q == S:
            qry[b], qv[b, :ns] = sup[b], True
            continue
        nq = n_valid_q - 31 * b
        pick = np.sort(rs.choice(ns, nq, replace=False))
        qry[b, :nq] = sup[b, pick] + rs.normal(0, 0.01, (nq, 3)).astype(np.float32)
        qv[b, :nq] = True
    return sup, qry, sv, qv


BKNN_CASES = {
    # S = 4096: NR = 32 rows, a 16-row window -- truly banded
    "banded-radius": dict(S=4096, Q=1500, ns=3900, nq=1400, hole=(1000, 1300),
                          k=16, radius=0.12, win_rows=16),
    "banded-noradius": dict(S=4096, Q=4096, ns=3700, nq=None, hole=(40, 70),
                            k=16, radius=None, win_rows=16),
    # S = 2048: NR = 16 rows, the 64-row window covers the grid
    "covering": dict(S=2048, Q=700, ns=2000, nq=600, hole=(50, 90), k=8,
                     radius=0.05, win_rows=64),
}


@pytest.mark.parametrize("case", sorted(BKNN_CASES))
def test_banded_knn_plain_matches_pallas(case):
    c = BKNN_CASES[case]
    sup, qry, sv, qv = _clouds(11, c["S"], c["Q"], c["ns"], c["nq"], c["hole"])
    d, i, v = knn_cuda.banded_knn_plain(_t(qry), _t(sup), _t(sv), _t(qv),
                                        c["k"], c["radius"], c["win_rows"])
    for b in range(2):
        dj, ij, vj = gp.banded_knn_tpu.__wrapped__(
            jnp.asarray(qry[b]), jnp.asarray(sup[b]), jnp.asarray(sv[b]),
            jnp.asarray(qv[b]), c["k"], c["radius"], win_rows=c["win_rows"])
        vj = np.asarray(vj)
        np.testing.assert_array_equal(v[b].numpy(), vj)
        np.testing.assert_array_equal(d[b].numpy(), np.asarray(dj))
        np.testing.assert_array_equal(i[b].numpy()[vj], np.asarray(ij)[vj])
    assert v.any() and (c["radius"] is None) == bool(v.all())


def _random_keys(rs, shape, lo=0x0DA20000, hi=0x4E6E0000):
    n = int(np.prod(shape))
    keys = rs.choice(np.arange(lo, hi, 7919, dtype=np.int64), n, replace=False)
    return keys.astype(np.int32).reshape(shape)


@pytest.mark.parametrize("k", [8, 16])
def test_topk_keys_plain_matches_pallas(k):
    """Random unique keys; the second row block also holds duplicates and
    keys above 1e9's bits, where the knock-out emits 1e9."""
    rs = np.random.RandomState(k)
    keys = _random_keys(rs, (40, 256))
    keys[20:, :250] = 0x4E6F0000 + rs.randint(0, 1 << 16, (20, 250))
    keys[20:, 250:] = keys[20:, 250:251]
    want = gp.topk_packed_tpu(jnp.asarray(keys[:, :128]).view(jnp.float32),
                              jnp.asarray(keys[:, 128:]).view(jnp.float32), k)
    got = knn_cuda.topk_keys_plain(_t(keys), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).view(np.int32))
    assert (got.numpy()[20:, 1:] == knn_cuda.BIG_KEY).all()


@pytest.mark.parametrize("S,Q", [(4096, 1200), (2600, 2600)])
def test_banded_nn1_plain_matches_pallas(S, Q):
    sup, qry, sv, qv = _clouds(5, S, Q, S - 150, Q - 100, hole=(300, 420))
    d, i = knn_cuda.banded_nn1_plain(_t(qry), _t(sup), _t(sv), _t(qv))
    for b in range(2):
        dj, ij = gp.banded_nn1_tpu.__wrapped__(
            jnp.asarray(qry[b]), jnp.asarray(sup[b]), jnp.asarray(sv[b]),
            jnp.asarray(qv[b]))
        np.testing.assert_array_equal(i[b].numpy(), np.asarray(ij))
        np.testing.assert_array_equal(d[b].numpy(), np.asarray(dj))


def test_window_starts_follow_valid_ratio():
    """Tile i of a query level with half the support's valid count centres
    on support rank ~ 2*(32 i + 16); starts stay 8-aligned and clipped."""
    sv = torch.zeros((1, 8192), dtype=torch.bool)
    sv[0, :8000] = True
    qv = torch.zeros((1, 4096), dtype=torch.bool)
    qv[0, :4000] = True
    r0 = knn_cuda.window_starts(sv, qv, NR=64, LW=16)[0]
    assert r0.shape == (128,) and (r0 % 8 == 0).all()
    assert int(r0[0]) == 0 and int(r0[-1]) == 48
    assert int(r0[32]) == 8      # row (32*32+16)*2/128 = 16.25 -> 16 - 8


# support size per pyramid search at a plan: (points_l0, points_l1, points_l2)
def _searches(st):
    l0, l1, l2 = st.points_l0, st.points_l1, st.points_l2
    knn = {"l0 kNN": l0, "l1 kNN": l1, "l2 kNN": l2, "pool 0": l0,
           "pool 1": l1}
    nn = {"l0 -> l1": l1, "l1 -> l2": l2}
    return knn, nn


@pytest.mark.parametrize("preset,dense", [("3DMatch", {"l2 kNN"}),
                                          ("KITTI", set())])
def test_dispatch_at_the_presets(preset, dense):
    """The branch each pyramid search takes at the shipped plans
    (knn_band = 4096), from the shapes alone."""
    st = tconfig.make_cfg(preset).static
    assert st.knn_band == 4096
    knn, nn = _searches(st)
    for name, S in knn.items():
        want = "dense" if name in dense else "banded"
        assert neighbors.knn_route(S, st.knn_band) == want, (preset, name)
    assert neighbors.nearest_route(nn["l0 -> l1"], st.knn_band) == "banded"
    assert neighbors.nearest_route(nn["l1 -> l2"], st.knn_band) == "exact"
    # KITTI's level 2 (6144 points, 48 rows) lies under the 64-row window
    assert knn_cuda.banded_win_rows(6144, 4096) == (64, True)
    # knn_band = 0 is the exact path everywhere
    for S in list(knn.values()) + list(nn.values()):
        assert neighbors.knn_route(S, 0) == "dense"
        assert neighbors.nearest_route(S, 0) == "exact"


def test_dispatch_raises_for_unported_fallback():
    # a restricting band on a support past the 16-bit rank range, and on
    # one with fewer than 16 grid rows: the reference takes its XLA
    # fallbacks radius_knn_banded / nearest_banded there
    for S, band in ((70000, 4096), (1500, 512)):
        assert not knn_cuda.banded_supported(S)
        with pytest.raises(NotImplementedError, match="radius_knn_banded"):
            neighbors.knn_route(S, band)
        with pytest.raises(NotImplementedError, match="nearest_banded"):
            neighbors.nearest_route(S, band)
    # a band that does not restrict keeps the exact searches
    assert neighbors.nearest_route(1500, 1024) == "exact"
    assert neighbors.knn_route(1500, 1024) == "dense"


@pytest.mark.parametrize("n_elig", [None, 30, 0])
def test_fps_single_matches_pallas(n_elig):
    rs = np.random.RandomState(9)
    N, S = 1500, 48
    pts = rs.randn(N, 3).astype(np.float32)
    elig = rs.rand(N) > 0.4
    if n_elig is not None:
        elig[:] = False
        elig[rs.choice(N, n_elig, replace=False)] = True
    want = np.asarray(fp.fps_pallas(jnp.asarray(pts), jnp.asarray(elig), S))
    idx, valid = sampling.farthest_point_sample(_t(pts), _t(elig), S)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(valid.numpy(),
                                  np.arange(S) < int(elig.sum()))


def test_banded_wrappers_take_plain_versions_on_cpu():
    cuda.reset_launches()
    sup, qry, sv, qv = _clouds(2, 2048, 512, 2000, 480)
    args = (_t(qry), _t(sup), _t(sv), _t(qv))
    for got, want in zip(knn_cuda.banded_knn_cuda(*args, 8, 0.1, 64),
                         knn_cuda.banded_knn_plain(*args, 8, 0.1, 64)):
        assert torch.equal(got, want)
    for got, want in zip(knn_cuda.banded_nn1_cuda(*args),
                         knn_cuda.banded_nn1_plain(*args)):
        assert torch.equal(got, want)
    d, i, v = neighbors.radius_knn(args[0], args[1], args[2], 8, 0.1,
                                   band=512, query_valid=args[3])
    assert torch.equal(i[v], knn_cuda.banded_knn_plain(*args, 8, 0.1, 64)[1][v])
    assert max(cuda.launch_counts().values()) == 0
    with pytest.raises(ValueError, match="query_valid"):
        neighbors.nearest(args[0], args[1], args[2], band=512)
