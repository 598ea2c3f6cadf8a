"""The port's configuration, core math, host data preparation and neighbour
ops against the JAX package on the CPU, and the guard that the port never
imports JAX or the JAX package.  Inputs come from numpy seeds."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import buffer_tpu.config as jconfig
from buffer_tpu.core import gridmath as jgridmath, se3 as jse3
from buffer_tpu.data import preprocess as jpre
from buffer_tpu.kernels.host import voxel_subsample_host as j_voxel
from buffer_tpu.ops import neighbors as jnb, normals as jnormals

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.core import gridmath, se3
from buffer_tpu_torch.data import preprocess
from buffer_tpu_torch.data.host import voxel_subsample_host
from buffer_tpu_torch.ops import neighbors, normals

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", list(jconfig.PRESETS) + ["tiny", "small"])
def test_config_copy_matches_reference(name):
    plans = {"tiny": "tiny_cfg", "small": "small_cfg"}
    if name in plans:
        j, t = getattr(jconfig, plans[name])(), getattr(tconfig, plans[name])()
    else:
        j, t = jconfig.make_cfg(name), tconfig.make_cfg(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tconfig.unbanded(t).static.knn_band == 0


def test_gridmath_tables_match():
    np.testing.assert_array_equal(gridmath.get_voxel_coordinate(1.0, 3, 20, 7),
                                  jgridmath.get_voxel_coordinate(1.0, 3, 20, 7))
    np.testing.assert_array_equal(gridmath.azimuth_derotations(20),
                                  jgridmath.azimuth_derotations(20))


def test_se3_helpers_match():
    rs = np.random.RandomState(0)
    aa = rs.randn(16, 3).astype(np.float32)
    a = rs.randn(16, 3).astype(np.float32)
    b = rs.randn(16, 3).astype(np.float32)
    pts = rs.randn(16, 50, 3).astype(np.float32)
    u = rs.rand(3).astype(np.float32)
    # float32 transcendental and 3x3 products: a few ulps apart
    tol = dict(rtol=1e-5, atol=2e-6)
    Rj = np.asarray(jse3.angle_axis_to_rotation_matrix(jnp.asarray(aa)))
    np.testing.assert_allclose(se3.angle_axis_to_rotation_matrix(_t(aa)).numpy(), Rj, **tol)
    np.testing.assert_allclose(se3.rodrigues_a_to_b(_t(a), _t(b)).numpy(),
                               np.asarray(jse3.rodrigues_a_to_b(jnp.asarray(a), jnp.asarray(b))), **tol)
    T = se3.integrate_trans(_t(Rj), _t(a))
    np.testing.assert_array_equal(
        T.numpy(), np.asarray(jse3.integrate_trans(jnp.asarray(Rj), jnp.asarray(a))))
    np.testing.assert_allclose(se3.transform(_t(pts), T).numpy(),
                               np.asarray(jse3.transform(jnp.asarray(pts), jnp.asarray(T.numpy()))), **tol)
    q = se3.rotation_matrix_to_quaternion(_t(Rj))
    np.testing.assert_allclose(q.numpy(), np.asarray(jse3.rotation_matrix_to_quaternion(jnp.asarray(Rj))), **tol)
    np.testing.assert_allclose(se3.quaternion_to_rotation_matrix(q).numpy(), Rj, rtol=1e-4, atol=1e-5)
    # random_rotation from the same uniforms as jax.random.uniform(key, (3,))
    key = jax.random.PRNGKey(11)
    uj = np.asarray(jax.random.uniform(key, (3,), dtype=jnp.float32))
    for axes in (1, 3):
        np.testing.assert_allclose(se3.random_rotation(_t(uj), axes).numpy(),
                                   np.asarray(jse3.random_rotation(key, axes)), **tol)


@pytest.mark.parametrize("zero_weights", [False, True])
def test_kabsch_quat_matches(zero_weights):
    """Power-iteration Kabsch, including all-zero weights (the degenerate
    case RANSAC and IRLS hit when nothing is an inlier)."""
    rs = np.random.RandomState(1)
    A = rs.randn(8, 30, 3).astype(np.float32)
    R = np.asarray(jse3.random_rotation(jax.random.PRNGKey(2), 3))
    B = (A @ R.T + np.array([0.3, -0.2, 0.5], np.float32)
         + 0.01 * rs.randn(8, 30, 3)).astype(np.float32)
    w = (rs.rand(8, 30) > 0.3).astype(np.float32)
    if zero_weights:
        w[:4] = 0.0
    got = se3.kabsch_quat(_t(A), _t(B), _t(w)).numpy()
    want = np.asarray(jse3.kabsch_quat(jnp.asarray(A), jnp.asarray(B), jnp.asarray(w)))
    assert np.isfinite(got).all()
    # 60 fp32 power iterations in two frameworks: 1e-4 on unit-scale poses
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if not zero_weights:
        np.testing.assert_allclose(got[:, :3, :3], np.broadcast_to(R, (8, 3, 3)), atol=2e-2)


def test_normals_match():
    rs = np.random.RandomState(2)
    B, N, k = 2, 300, 8
    pts = rs.randn(B, N, 3).astype(np.float32)
    pts[..., 2] = 0.1 * pts[..., 2] + 1.0
    valid = rs.rand(B, N) > 0.1
    _, idx, nv = jax.vmap(lambda p, m: jnb.radius_knn(p, p, m, k=k))(
        jnp.asarray(pts), jnp.asarray(valid))
    want = np.asarray(jnormals.normals_from_neighbors(
        jnp.asarray(pts), jnp.asarray(valid), idx, nv))
    got = normals.normals_from_neighbors(_t(pts), _t(valid), _t(idx), _t(nv)).numpy()
    # same closed-form eigensolver: signs agree, values to fp32 rounding
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    cov = rs.randn(64, 3, 3).astype(np.float32)
    cov = cov @ cov.transpose(0, 2, 1)
    np.testing.assert_allclose(
        normals.smallest_eigvec_sym3(_t(cov)).numpy(),
        np.asarray(jnormals.smallest_eigvec_sym3(jnp.asarray(cov))), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("radius", [None, 0.5])
def test_radius_knn_matches(radius):
    rs = np.random.RandomState(3)
    B, Q, S, k = 2, 200, 300, 12
    q = rs.randn(B, Q, 3).astype(np.float32)
    s = rs.randn(B, S, 3).astype(np.float32)
    valid = rs.rand(B, S) > 0.2
    d, i, v = neighbors.radius_knn(_t(q), _t(s), _t(valid), k, radius,
                                   query_chunk=64)
    for b in range(B):
        dj, ij, vj = jnb.radius_knn(jnp.asarray(q[b]), jnp.asarray(s[b]),
                                    jnp.asarray(valid[b]), k, radius,
                                    chunk=128, query_chunk=64)
        np.testing.assert_array_equal(v[b].numpy(), np.asarray(vj))
        # random points: no distance ties, so the sorted lists are equal
        np.testing.assert_array_equal(i[b].numpy(), np.asarray(ij))
        np.testing.assert_allclose(d[b].numpy(), np.asarray(dj), rtol=1e-5, atol=1e-5)
    # a restricting band on a support the banded kernel cannot take (300
    # points, under 16 grid rows) runs the fallback radius_knn_banded, as
    # JAX's radius_knn does: the same valid count for every query
    assert neighbors.knn_route(S, 64) == "fallback"
    _, _, vb = neighbors.radius_knn(_t(q), _t(s), _t(valid), k, radius, band=64)
    for b in range(B):
        _, _, vj = jnb.radius_knn(jnp.asarray(q[b]), jnp.asarray(s[b]),
                                  jnp.asarray(valid[b]), k, radius, band=64)
        np.testing.assert_array_equal(vb[b].sum(-1).numpy(),
                                      np.asarray(vj).sum(-1))
    # a band covering the support is ignored, as in the reference
    neighbors.radius_knn(_t(q), _t(s), _t(valid), k, radius, band=S)


def test_host_subsample_and_prepare_pair_match():
    rs = np.random.RandomState(4)
    raw = rs.uniform(-0.6, 0.6, (900, 3)).astype(np.float32)
    raw[:, 2] = 0.25 * np.sin(4 * raw[:, 0]) + 1.5
    np.testing.assert_array_equal(voxel_subsample_host(raw, 0.05), j_voxel(raw, 0.05))
    np.testing.assert_array_equal(preprocess.morton_sort(raw), jpre.morton_sort(raw))
    cfg_t, cfg_j = tconfig.tiny_cfg(), jconfig.tiny_cfg()
    tgt = raw + np.float32(0.05)
    got = preprocess.prepare_pair(cfg_t, raw.copy(), tgt.copy(),
                                  rs=np.random.RandomState(5), device="cpu")
    want = jpre.prepare_pair(cfg_j, raw.copy(), tgt.copy(),
                             rs=np.random.RandomState(5))
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port with JAX blocked succeeds, and no
    file of the port or chip_smoke.py names buffer_tpu or the repository's
    bench.py in an import."""
    pkg = REPO / "buffer_tpu_torch"
    mods = sorted("buffer_tpu_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
                  for p in pkg.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys; sys.modules['jax'] = None; sys.modules['buffer_tpu'] = None\n"
            "sys.modules['bench'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)
    files = list(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert not (n == "jax" or n.startswith("jax.") or n == "buffer_tpu"
                            or n.startswith("buffer_tpu.")), (f, n)
