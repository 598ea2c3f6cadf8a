"""Calibration on the CPU: ``data/host.py``'s native bindings against the JAX
package's ``kernels/host.py`` (the same C++ of ``cpp/host_ops.cpp``, so bit
for bit) and ``scripts/calibrate.main`` against the JAX script over the
3DMatch fixture tree."""

import importlib.util
import os

import numpy as np
import pytest

from buffer_tpu.kernels import host as jhost

from buffer_tpu_torch.data import host as thost
from buffer_tpu_torch.scripts import calibrate

import fixtures_gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def clouds():
    rs = np.random.RandomState(12)
    surf = fixtures_gen.surface_cloud(4000, 3)
    return {"uniform": (rs.rand(3000, 3).astype(np.float32),
                        rs.rand(700, 3).astype(np.float32)),
            "surface": (surf, surf[::5] + np.float32(0.004))}


@pytest.mark.parametrize("kind", ["uniform", "surface"])
@pytest.mark.parametrize("name,args", [
    pytest.param("radius_neighbors_host", lambda s, q: (q, s, 0.09, 24),
                 id="radius"),
    pytest.param("knn_host", lambda s, q: (q, s, 12), id="knn"),
    pytest.param("knn_host", lambda s, q: (q, s, 5, 0.05), id="knn-cell"),
    pytest.param("normals_host", lambda s, q: (s,), id="normals"),
    pytest.param("normals_host", lambda s, q: (q, 10), id="normals-k10"),
    pytest.param("fps_host", lambda s, q: (s, 200), id="fps"),
])
def test_host_bindings_match_jax(clouds, kind, name, args):
    assert jhost._load() is not None, "the JAX package's native library"
    a = args(*clouds[kind])
    got, want = getattr(thost, name)(*a), getattr(jhost, name)(*a)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_fps_host_rejects_an_empty_cloud():
    with pytest.raises(ValueError):
        thost.fps_host(np.zeros((0, 3), np.float32), 4)


def _suggestions(text: str):
    return text[text.index("Suggested"):].strip().splitlines()


def test_calibrate_prints_jax_suggestions(tmp_path, capsys, monkeypatch):
    """``calibrate.main`` over the 3DMatch fixture tree prints the JAX
    script's suggestions line for line and returns them."""
    root = str(tmp_path / "3dm")
    os.makedirs(root)
    fixtures_gen.make_threedmatch_tree(root)
    out = calibrate.main(["--config", "3DMatch", "--data-root", root,
                          "--samples", "3"])
    got = capsys.readouterr().out

    spec = importlib.util.spec_from_file_location(
        "jax_calibrate", os.path.join(REPO, "scripts", "calibrate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr("sys.argv", ["calibrate.py", "--config", "3DMatch",
                                     "--data-root", root, "--samples", "3"])
    mod.main()
    want = capsys.readouterr().out
    assert _suggestions(got) == _suggestions(want)
    assert "[3/3] done" in got
    assert set(out) == {"neighbors_l0", "neighbors_l1", "neighbors_l2",
                        "pools_l0", "pools_l1", "points_l0", "points_l1",
                        "points_l2", "raw"}
    assert all(v["max"] > 0 for v in out.values())
