"""The port's data layer against the JAX package's, on the same inputs: PLY
and raw binary I/O, the 3DMatch, KITTI and ETH loaders over the miniature
trees of ``fixtures_gen.py`` (the real on-disk formats), and the synthetic
room generator with its ground-truth check.  Loaders and the generator
must agree exactly (KITTI's ICP-refined ground truth to 1e-6)."""

import os
import shutil

import numpy as np
import pytest

import jax  # noqa: F401  (keeps JAX on the CPU backend set by conftest)

import buffer_tpu.config as jconfig
from buffer_tpu.data import eth as jeth
from buffer_tpu.data import kitti as jkitti
from buffer_tpu.data import ply as jply
from buffer_tpu.data import synthetic as jsyn
from buffer_tpu.data import threedmatch as jtdm
from buffer_tpu.utils import io as jio

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.data import eth, kitti, ply, synthetic, threedmatch
from buffer_tpu_torch.utils import io

import fixtures_gen


def _with_root(mod, name, root):
    c = mod.make_cfg(name)
    return c.replace(data=c.data.__class__(**{**c.data.__dict__, "root": root}))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One 3DMatch and one ETH tree; two identical KITTI trees, one for each
    package, because the loader writes its ICP cache into the tree."""
    base = tmp_path_factory.mktemp("torch_data")
    out = {}
    for name in ("3dm", "kitti_jax", "kitti_port", "eth"):
        out[name] = str(base / name)
        os.makedirs(out[name])
    fixtures_gen.make_threedmatch_tree(out["3dm"])
    fixtures_gen.make_kitti_tree(out["kitti_jax"])
    fixtures_gen.make_kitti_tree(out["kitti_port"])
    fixtures_gen.make_eth_tree(out["eth"])
    return out


def _assert_items_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("fmt", ["binary_little_endian", "binary_big_endian",
                                 "ascii"])
def test_read_ply_points_matches_jax(tmp_path, fmt):
    """Both encodings (with an extra vertex property and a face element),
    read by both packages; the writers write the same bytes."""
    rs = np.random.RandomState(0)
    pts = rs.randn(50, 3).astype(np.float32)
    path = str(tmp_path / "x.ply")
    header = (f"ply\nformat {fmt} 1.0\nelement vertex 50\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nelement face 0\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        if fmt == "ascii":
            f.write("".join(f"{a!r} {b!r} {c!r} 7\n" for a, b, c in
                            pts.tolist()).encode())
        else:
            e = "<" if fmt == "binary_little_endian" else ">"
            rec = np.zeros(50, [("x", e + "f4"), ("y", e + "f4"),
                                ("z", e + "f4"), ("r", "u1")])
            rec["x"], rec["y"], rec["z"] = pts.T
            f.write(rec.tobytes())
    got = ply.read_ply_points(path)
    np.testing.assert_array_equal(got, jply.read_ply_points(path))
    np.testing.assert_array_equal(got, pts)
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    ply.write_ply_points(a, pts)
    jply.write_ply_points(b, pts)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_binary_io_matches_jax(tmp_path):
    rs = np.random.RandomState(1)
    kp, desc = rs.randn(40, 3), rs.randn(40, 32)
    idx = rs.randint(0, 1000, 40).astype(np.int64)
    io.save_keypts(str(tmp_path / "k"), kp)
    jio.save_keypts(str(tmp_path / "kj"), kp)
    io.save_desc(str(tmp_path / "d"), desc)
    jio.save_desc(str(tmp_path / "dj"), desc)
    idx.tofile(str(tmp_path / "i"))
    for ours, theirs in (("k", "kj"), ("d", "dj")):
        assert (open(tmp_path / ours, "rb").read()
                == open(tmp_path / theirs, "rb").read())
    np.testing.assert_array_equal(io.get_keypts(str(tmp_path / "k")),
                                  jio.get_keypts(str(tmp_path / "k")))
    np.testing.assert_array_equal(io.get_desc(str(tmp_path / "d")),
                                  jio.get_desc(str(tmp_path / "d")))
    np.testing.assert_array_equal(io.get_keypts_indices(str(tmp_path / "i")),
                                  jio.get_keypts_indices(str(tmp_path / "i")))
    np.testing.assert_array_equal(io.get_desc(str(tmp_path / "d")),
                                  desc.astype(np.float32))


def test_threedmatch_test_split_matches_jax(trees):
    tcfg = _with_root(tconfig, "3DMatch", trees["3dm"])
    jcfg = _with_root(jconfig, "3DMatch", trees["3dm"])
    got = threedmatch.ThreeDMatchDataset("test", tcfg)
    want = jtdm.ThreeDMatchDataset("test", jcfg)
    assert got.files == want.files and len(got) == 3
    for a, b in zip(got.poses, want.poses):
        np.testing.assert_array_equal(a, b)
    for i in range(len(want)):
        _assert_items_equal(got[i], want[i])


@pytest.mark.parametrize("split", ["train", "val"])
def test_threedmatch_train_split_matches_jax(trees, monkeypatch, split):
    """With equal seeded RandomStates (the JAX loader draws from a fresh
    ``RandomState()`` an item, here seeded) the swap, rotation and jitter
    agree."""
    tcfg = _with_root(tconfig, "3DMatch", trees["3dm"])
    jcfg = _with_root(jconfig, "3DMatch", trees["3dm"])
    real = np.random.RandomState
    for seed in (5, 8):   # one seed swaps the pair, the other does not
        got = threedmatch.ThreeDMatchDataset(split, tcfg, rs=real(seed))
        want = jtdm.ThreeDMatchDataset(split, jcfg)
        assert got.files == want.files and len(got) == 1
        monkeypatch.setattr(np.random, "RandomState",
                            lambda *a: real(*a) if a else real(seed))
        w = want[0]
        monkeypatch.setattr(np.random, "RandomState", real)
        _assert_items_equal(got[0], w)


def test_np_rotation_matches_jax():
    for axes in (0, 1, 3):
        np.testing.assert_array_equal(
            threedmatch._np_rotation(np.random.RandomState(2), axes),
            jtdm._np_rotation(np.random.RandomState(2), axes))


def test_kitti_test_split_matches_jax(trees):
    """Pair mining, velo2cam, the ICP-refined ground truth (to 1e-6; both
    cached in their trees) and the items."""
    tcfg = _with_root(tconfig, "KITTI", trees["kitti_port"])
    jcfg = _with_root(jconfig, "KITTI", trees["kitti_jax"])
    np.testing.assert_array_equal(kitti.velo2cam(), jkitti.velo2cam())
    got = kitti.KITTIDataset("test", tcfg)
    want = jkitti.KITTIDataset("test", jcfg)
    assert got.files == want.files == [(8, 0, 1)]
    g, w = got[0], want[0]
    np.testing.assert_allclose(g["relt_pose"], w["relt_pose"], rtol=0, atol=1e-6)
    for k in ("src_fds_pts", "tgt_fds_pts"):
        np.testing.assert_array_equal(g[k], w[k])
    assert (g["src_id"], g["tgt_id"]) == (w["src_id"], w["tgt_id"])
    cached = [np.load(os.path.join(t, "icp", "8_0_1.npy"))
              for t in (trees["kitti_port"], trees["kitti_jax"])]
    np.testing.assert_allclose(cached[0], cached[1], rtol=0, atol=1e-6)
    # a second read takes the cache
    np.testing.assert_array_equal(got[0]["relt_pose"], g["relt_pose"])


def test_kitti_train_split_matches_jax(trees, monkeypatch, tmp_path):
    """The training split (jitter and SO(2) rotation) with equal seeded
    RandomStates, on copies of the KITTI tree whose ICP caches are equal."""
    roots = []
    for name in ("kitti_port", "kitti_jax"):
        root = str(tmp_path / name)
        shutil.copytree(trees[name], root)
        roots.append(root)
    tcfg = _with_root(tconfig, "KITTI", roots[0])
    jcfg = _with_root(jconfig, "KITTI", roots[1])
    got = kitti.KITTIDataset("train", tcfg, rs=np.random.RandomState(4))
    want = jkitti.KITTIDataset("train", jcfg)
    assert got.files == want.files == [(8, 0, 1)]
    real = np.random.RandomState
    g = got[0]
    monkeypatch.setattr(np.random, "RandomState",
                        lambda *a: real(*a) if a else real(4))
    w = want[0]
    monkeypatch.setattr(np.random, "RandomState", real)
    np.testing.assert_allclose(g["relt_pose"], w["relt_pose"], rtol=0, atol=1e-6)
    for k in ("src_fds_pts", "tgt_fds_pts"):
        np.testing.assert_array_equal(g[k], w[k])


def test_icp_point_to_point_matches_jax():
    rs = np.random.RandomState(6)
    src = fixtures_gen.surface_cloud(3000, 3)
    ang = 0.05
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                  [0, 0, 1]])
    tgt = (src @ R.T + [0.03, -0.02, 0.01] + rs.randn(3000, 3) * 0.002)
    np.testing.assert_array_equal(
        kitti.icp_point_to_point(src, tgt.astype(np.float32)),
        jkitti.icp_point_to_point(src, tgt.astype(np.float32)))


def test_eth_test_split_matches_jax(trees):
    tcfg = _with_root(tconfig, "ThreeD2ETH", trees["eth"])
    jcfg = _with_root(jconfig, "ThreeD2ETH", trees["eth"])
    assert eth.ETH_SCENES == jeth.ETH_SCENES
    got = eth.ETHDataset("test", tcfg)
    want = jeth.ETHDataset("test", jcfg)
    assert got.files == want.files and len(got) == 1
    _assert_items_equal(got[0], want[0])
    with pytest.raises(ValueError):
        eth.ETHDataset("train", tcfg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_room_pair_matches_jax(seed):
    """Bit-equal PairInputs and pose from equal RandomStates at the tiny
    plan, and equal ground-truth checks."""
    got, T = synthetic.make_room_pair(tconfig.tiny_cfg(),
                                      np.random.RandomState(seed), device="cpu")
    want, Tj = jsyn.make_room_pair(jconfig.tiny_cfg(),
                                   np.random.RandomState(seed))
    np.testing.assert_array_equal(T, Tj)
    assert T.dtype == Tj.dtype
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    r = synthetic.icp_check_gt(got, T, 0.1)
    assert r == jsyn.icp_check_gt(want, Tj, 0.1)
    assert r[0] < 0.05 and r[2] > 0.25
    # a wrong pose (twice the translation) is caught by the match residual
    bad = T.copy()
    bad[:3, 3] *= 2
    assert (synthetic.icp_check_gt(got, bad, 0.1)
            == jsyn.icp_check_gt(want, bad, 0.1))


def test_shoemake_rotation_matches_jax():
    R = synthetic._shoemake_rotation(np.random.RandomState(9))
    np.testing.assert_array_equal(R, jsyn._shoemake_rotation(
        np.random.RandomState(9)))
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
