"""The last modules of the port on the CPU against the JAX package:
``describe_cloud`` (one cloud's descriptors, fused and sampled, with and
without axes), ``estimate_normals`` / ``cal_z_axis`` / ``axis_align``
without an axis, the SE(3) functions ``decompose_trans``, ``concatenate``,
``inverse`` and the SVD ``kabsch``, the JAX trainer's flax-msgpack
checkpoints both ways (``load_file``, ``save_variables``,
``load_jax_model``, ``state_dict_to_variables``, the entry points'
``best.msgpack``), and the FPS launch plan past 65536 points.

JAX's ``describe_cloud`` is held to the kernels' semantics as in
``test_torch_registration``: its ``extract_patches`` takes
``ball_sample_points_tpu`` and its fused front ``spt_pooled_tpu``, both in
Pallas interpret mode, fed JAX's draws from its ``k1``/``k2`` split.
Inputs come from numpy seeds."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization
from jax.experimental import pallas as pl

import buffer_tpu.config as jconfig
import buffer_tpu.kernels.geom_pallas as gp
from buffer_tpu.compat import torch_convert as jtc
from buffer_tpu.core import se3 as jse3
from buffer_tpu.models import patch_embedder as jpe
from buffer_tpu.models.composite import BufferModel as JModel
from buffer_tpu.ops import normals as jnormals
from buffer_tpu.pipeline import registration as jreg
from buffer_tpu.train import checkpoint as jck

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.compat.from_jax import (load_jax_model,
                                              state_dict_to_variables,
                                              variables_to_state_dict)
from buffer_tpu_torch.core import se3
from buffer_tpu_torch.kernels import fps_cuda
from buffer_tpu_torch.models import patch_embedder as pe
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.ops import normals
from buffer_tpu_torch.pipeline import registration
from buffer_tpu_torch.scripts import test as entry
from buffer_tpu_torch.scripts import train as train_entry
from buffer_tpu_torch.train import checkpoint

import fixtures_gen
from test_torch_registration import (_fused_kernel_semantics, _surface,
                                     _tpu_extract_patches)

torch.set_num_threads(1)
STAGES = ("Ref", "Desc", "Keypt", "Inlier")


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_variables(cfg, seed=0):
    jm = JModel(cfg)
    return jm, jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed)))


def _port_model(cfg, variables):
    model = BufferModel(cfg)
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           variables_to_state_dict(variables).items()})
    return model


def _assert_trees_equal(got, want, path=()):
    assert isinstance(got, dict) and set(got) == set(want), (path, got.keys()
                                                             ^ want.keys())
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], path + (k,))
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, path + (k,)
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# describe_cloud
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("with_axes", [True, False])
def test_describe_cloud_matches_jax(monkeypatch, fused, with_axes):
    """One cloud's MiniSpinNet at the tiny plan: desc, equi and R of the
    port within 1e-5 of JAX's (both fronts sum in other orders)."""
    monkeypatch.setattr(gp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jpe, "fused_point_features", _fused_kernel_semantics)
    monkeypatch.setattr(jpe, "extract_patches", _tpu_extract_patches)
    jcfg, tcfg = jconfig.tiny_cfg(), tconfig.tiny_cfg()
    if not fused:
        off = lambda c: c.replace(static=dataclasses.replace(
            c.static, fused_desc=False))
        jcfg, tcfg = off(jcfg), off(tcfg)
    jm, variables = _jax_variables(jcfg)
    model = _port_model(tcfg, variables)
    R, S = tcfg.static.raw_points, tcfg.patch.num_points_per_patch
    rs = np.random.RandomState(0)
    pts = _surface(900, 0)
    raw = np.zeros((R, 3), np.float32)
    raw[:900] = pts
    mask = np.arange(R) < 900
    kpts = pts[rs.choice(900, tcfg.point.num_keypts, replace=False)]
    axes = rs.randn(len(kpts), 3).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    axes = axes if with_axes else None
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    prio = jax.random.uniform(k1, (R,), dtype=jnp.float32)
    spt_prio = jax.random.uniform(k2, (S,))
    want = jreg.describe_cloud(jm, variables, jcfg, key, jnp.asarray(raw),
                               jnp.asarray(mask), jnp.asarray(kpts),
                               None if axes is None else jnp.asarray(axes))
    got = registration.describe_cloud(model, tcfg, _t(prio), _t(spt_prio),
                                      _t(raw), _t(mask), _t(kpts),
                                      None if axes is None else _t(axes))
    assert got[0].shape == (len(kpts), 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# normals, cal_z_axis, axis_align without an axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("viewpoint", [None, (0.3, -2.0, 4.0)])
def test_estimate_normals_matches_jax(viewpoint):
    """JAX's single-cloud ``estimate_normals`` against the port's, on one
    cloud [N, 3] and on the batch [2, N, 3]: within 1e-5 but for at most
    2 normals a cloud whose 16th and 17th neighbours tie to fp32 rounding
    (ROADMAP section 3's allowance)."""
    clouds, masks = [], []
    for seed in (1, 2):
        pts = np.zeros((700, 3), np.float32)
        pts[:650] = _surface(650, seed)
        clouds.append(pts)
        masks.append(np.arange(700) < 650)
    vp = None if viewpoint is None else np.float32(viewpoint)
    want = [np.asarray(jnormals.estimate_normals(
        jnp.asarray(p), jnp.asarray(m), knn=16, chunk=256,
        viewpoint=None if vp is None else jnp.asarray(vp)))
        for p, m in zip(clouds, masks)]
    tvp = None if vp is None else _t(vp)
    one = normals.estimate_normals(_t(clouds[0]), _t(masks[0]), knn=16,
                                   chunk=256, viewpoint=tvp)
    both = normals.estimate_normals(_t(np.stack(clouds)), _t(np.stack(masks)),
                                    knn=16, chunk=256, viewpoint=tvp)
    assert one.shape == (700, 3) and both.shape == (2, 700, 3)
    assert torch.equal(one, both[0])
    for b in range(2):
        err = np.abs(both[b].numpy() - want[b]).max(-1)
        assert (err > 1e-5).sum() <= 2, err.max()
        assert (both[b].numpy()[~masks[b]] == 0).all()
        facing = np.sum(both[b].numpy() * ((0.0 if vp is None else vp)
                                           - clouds[b]), -1)
        assert (facing[masks[b]] >= 0).all()


def _patches(seed, K=40, S=64):
    rs = np.random.RandomState(seed)
    center = rs.uniform(-1, 1, (K, 3)).astype(np.float32)
    local = rs.randn(K, S, 3).astype(np.float32) * np.float32([0.1, 0.08, 0.01])
    patches = center[:, None] + local
    patches[:, -1] = center
    return patches


def test_cal_z_axis_matches_jax():
    patches = _patches(4)
    delta = patches - patches[:, -1:]
    ref = patches[:, -1]
    want = np.asarray(jnormals.cal_z_axis(jnp.asarray(delta), jnp.asarray(ref)))
    got = normals.cal_z_axis(_t(delta), _t(ref)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (np.sum(-got * ref, -1) >= 0).all()


@pytest.mark.parametrize("dataset", ["3DMatch", "KITTI"])
def test_axis_align_without_axis_matches_jax(dataset):
    patches = _patches(5)
    want = jpe.axis_align(jnp.asarray(patches), dataset, None)
    got = pe.axis_align(_t(patches), dataset)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def _transforms(rs, n):
    R = np.stack([np.linalg.qr(rs.randn(3, 3))[0] for _ in range(n)])
    R *= np.sign(np.linalg.det(R))[:, None, None]
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rs.uniform(-2, 2, (n, 3))
    return T.astype(np.float32)


def test_decompose_concatenate_inverse_match_jax():
    rs = np.random.RandomState(6)
    T1, T2 = _transforms(rs, 5), _transforms(rs, 5)
    for g, w in zip(se3.decompose_trans(_t(T1)), jse3.decompose_trans(jnp.asarray(T1))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(se3.concatenate(_t(T1), _t(T2)).numpy(),
                               np.asarray(jse3.concatenate(jnp.asarray(T1),
                                                           jnp.asarray(T2))),
                               rtol=0, atol=1e-6)
    inv = se3.inverse(_t(T1))
    np.testing.assert_allclose(inv.numpy(), np.asarray(jse3.inverse(jnp.asarray(T1))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(se3.concatenate(inv, _t(T1)).numpy(),
                               np.tile(np.eye(4, dtype=np.float32), (5, 1, 1)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_kabsch_matches_jax(weighted):
    """The SVD Kabsch of both packages within 1e-5 on noisy correspondences
    (and a reflection-prone planar set), and within 1e-5 of the port's
    power-iteration ``kabsch_quat``."""
    rs = np.random.RandomState(8)
    T = _transforms(rs, 4)
    A = rs.uniform(-1, 1, (4, 200, 3)).astype(np.float32)
    A[3, :, 2] = 0.0                                   # planar: det sign
    B = (np.einsum("bij,bnj->bni", T[:, :3, :3], A) + T[:, None, :3, 3]
         + rs.normal(0, 0.005, A.shape)).astype(np.float32)
    w = (rs.rand(4, 200) * (rs.rand(4, 200) > 0.3)).astype(np.float32)
    w = w if weighted else None
    want = np.asarray(jse3.kabsch(jnp.asarray(A), jnp.asarray(B),
                                  None if w is None else jnp.asarray(w)))
    got = se3.kabsch(_t(A), _t(B), None if w is None else _t(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), T, rtol=0, atol=5e-3)
    quat = se3.kabsch_quat(_t(A), _t(B), None if w is None else _t(w))
    np.testing.assert_allclose(got.numpy(), quat.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the JAX trainer's msgpack checkpoints
# ---------------------------------------------------------------------------

def test_load_file_reads_jax_save_variables(tmp_path):
    _, variables = _jax_variables(jconfig.tiny_cfg())
    path = str(tmp_path / "Ref" / "best.msgpack")
    jck.save_variables(variables, path)
    _assert_trees_equal(checkpoint.load_file(path), variables)
    # numpy scalars (ext type 3) and the other types of the format, as
    # flax writes them
    extra = {"step": np.int32(7), "lr": np.float32(1e-3), "tag": "x" * 40,
             "none": None, "flag": True, "big": 70000, "neg": -129,
             "f": 0.25, "blob": b"\x00" * 300, "list": [1, 2.5, "a"]}
    data = serialization.msgpack_serialize(extra)
    (tmp_path / "x.msgpack").write_bytes(data)
    got = checkpoint.load_file(str(tmp_path / "x.msgpack"))
    assert got == serialization.msgpack_restore(data)
    assert type(got["step"]) is np.int32 and got["lr"] == np.float32(1e-3)


def test_save_variables_reads_in_flax(tmp_path):
    """The port's file restores in flax to the same arrays, and holds the
    same bytes as flax's own ``to_bytes``."""
    _, variables = _jax_variables(jconfig.tiny_cfg())
    path = str(tmp_path / "v.msgpack")
    checkpoint.save_variables(variables, path)
    with open(path, "rb") as f:
        data = f.read()
    _assert_trees_equal(serialization.msgpack_restore(data), variables)
    assert data == serialization.to_bytes(variables)
    # tensors write as their arrays
    tv = jax.tree_util.tree_map(torch.from_numpy, variables)
    checkpoint.save_variables(tv, str(tmp_path / "t.msgpack"))
    assert open(tmp_path / "t.msgpack", "rb").read() == data


def test_load_file_raises_on_unknown_types(tmp_path):
    for blob in (b"\xc1", b"\xd4\x05\x00", b"\x81\xa1a"):
        (tmp_path / "bad.msgpack").write_bytes(blob)
        with pytest.raises(ValueError, match="msgpack"):
            checkpoint.load_file(str(tmp_path / "bad.msgpack"))


def test_state_dict_to_variables_is_convert_state_dict():
    _, variables = _jax_variables(jconfig.tiny_cfg())
    sd = variables_to_state_dict(variables)
    got = state_dict_to_variables(sd)
    _assert_trees_equal(got, variables)
    params, stats = jtc.convert_state_dict(sd)
    want = {s: dict(params=params[s], **({"batch_stats": stats[s]}
                                          if stats[s] else {}))
            for s in STAGES}
    _assert_trees_equal(got, want)
    tsd = BufferModel(tconfig.tiny_cfg(), seed=3).state_dict()
    _assert_trees_equal(variables_to_state_dict(state_dict_to_variables(tsd)),
                        {k: v.numpy() for k, v in tsd.items()
                         if not k.endswith("num_batches_tracked")}
                        | {k: np.array(0, np.int64) for k in tsd
                           if k.endswith("num_batches_tracked")})


def _write_jax_stages(d, variables):
    """JAX's trainer layout: every stage's best.msgpack holding the whole
    variables dict."""
    for s in STAGES:
        jck.save_variables(variables, os.path.join(d, s, "best.msgpack"))
    return {s: os.path.join(d, s, "best.msgpack") for s in STAGES}


def test_load_jax_model(tmp_path):
    """Each stage from its own file, as JAX's ``merge_stage_checkpoints``;
    equal to the state dict of ``variables_to_state_dict``; a file without
    a stage's entries raises."""
    cfg = tconfig.tiny_cfg()
    _, v0 = _jax_variables(jconfig.tiny_cfg(), 0)
    _, v1 = _jax_variables(jconfig.tiny_cfg(), 1)
    paths = _write_jax_stages(str(tmp_path / "a"), v0)
    paths["Desc"] = str(tmp_path / "desc.msgpack")
    jck.save_variables(v1, paths["Desc"])
    model = load_jax_model(cfg, paths, device="cpu")
    merged = jck.merge_stage_checkpoints(paths)
    want = variables_to_state_dict(jax.tree_util.tree_map(np.asarray, merged))
    assert set(model.state_dict()) == set(want)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k])
    assert not model.training
    jck.save_variables({s: v0[s] for s in STAGES if s != "Keypt"}
                       | {"Keypt": {"params": {}}}, paths["Keypt"])
    with pytest.raises(KeyError, match="missing"):
        load_jax_model(cfg, paths, device="cpu")


def test_test_entry_point_reads_jax_checkpoints(tmp_path, capsys):
    """``scripts/test.py --weights`` over ``<stage>/best.msgpack`` (written
    by the JAX trainer's ``save_variables``) gives the summary and est.log
    of the same weights as this package's ``best.pth``."""
    root = str(tmp_path / "3dm")
    os.makedirs(root)
    scene = fixtures_gen.make_threedmatch_tree(root)
    model = BufferModel(tconfig.tiny_cfg(), seed=5)
    for s in STAGES:
        checkpoint.save(model, str(tmp_path / "pth" / s / "best.pth"))
    params, stats = jtc.convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    _write_jax_stages(str(tmp_path / "jax"), {
        s: dict(params=params[s], **({"batch_stats": stats[s]} if stats[s]
                                     else {})) for s in STAGES})
    outs, logs = {}, {}
    for name in ("pth", "jax"):
        log_dir = str(tmp_path / ("log_" + name))
        out = entry.main(["--config", "3DMatch", "--tiny", "--device", "cpu",
                          "--data-root", root, "--weights",
                          str(tmp_path / name), "--log-dir", log_dir])
        outs[name] = {k: v for k, v in out.items() if not k.endswith("_time")}
        with open(os.path.join(log_dir, scene, "est.log")) as f:
            logs[name] = f.read()
        assert "'pairs': 3" in capsys.readouterr().out
    np.testing.assert_equal(outs["jax"], outs["pth"])      # NaN == NaN
    assert outs["jax"]["pairs"] == 3
    assert logs["pth"] == logs["jax"]


def test_train_entry_merges_jax_checkpoints(tmp_path):
    """``scripts/train.py``'s merge of the other stages takes
    ``<out>/<other>/best.msgpack`` where present, else ``--resume``'s."""
    cfg = tconfig.tiny_cfg()
    _, v0 = _jax_variables(jconfig.tiny_cfg(), 0)
    _, v1 = _jax_variables(jconfig.tiny_cfg(), 1)
    out, resume = str(tmp_path / "out"), str(tmp_path / "resume")
    jck.save_variables(v0, os.path.join(out, "Ref", "best.msgpack"))
    _write_jax_stages(resume, v1)
    model = BufferModel(cfg, seed=9)
    desc = {k: v.clone() for k, v in model.Desc.state_dict().items()}
    train_entry.load_other_stages(model, "Desc", out, resume)
    sd0, sd1 = variables_to_state_dict(v0), variables_to_state_dict(v1)
    for k, v in model.state_dict().items():
        stage = k.split(".")[0]
        if stage == "Desc":
            assert torch.equal(v, desc[k[len("Desc."):]])
        else:
            want = sd0[k] if stage == "Ref" else sd1[k]
            np.testing.assert_array_equal(v.numpy(), want)


# ---------------------------------------------------------------------------
# FPS past 65536 points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [65537, 81920, fps_cuda.MAX_POINTS])
def test_fps_plan_past_65536_points(N):
    """Past 65536 points the plan keeps 16 CTAs and 16 points a thread and
    grows the CTA to csrc/fps.cu's register budget (512 threads at 16
    points); each point owned once, no CTA empty."""
    C, T, P = plan = fps_cuda.fps_plan(N)
    assert P == 16 and C <= fps_cuda.MAX_CLUSTER
    assert T % 32 == 0 and fps_cuda.TARGET_THREADS < T <= fps_cuda.MAX_THREADS_16
    idx = fps_cuda.fps_points(plan)
    assert torch.equal(torch.sort(idx[idx < N]).values, torch.arange(N))
    assert (idx < N).reshape(C, -1).any(dim=1).all()
