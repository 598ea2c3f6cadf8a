"""The training slice's modules on the CPU against the JAX package: kernel #5
(``ball_sample_points``) against ``ball_sample_points_tpu`` in Pallas
interpret mode, the training front of the patch embedder (patches,
alignment, SO(2) augmentation, sampled SPT, ``var_to_invar``), the masked
train-mode batch norm, the Desc network's train-mode gradients and the
positive-pair sampler, exact and banded.  Inputs come from numpy seeds;
random draws are JAX's own, fed to both sides."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import buffer_tpu.config as jconfig
import buffer_tpu.kernels.geom_pallas as gp
import buffer_tpu.pipeline.train_forward as jtf
from buffer_tpu.core import gridmath as jgridmath
from buffer_tpu.data import preprocess as jpre
from buffer_tpu.models import patch_embedder as jpe
from buffer_tpu.models.composite import BufferModel as JModel
from buffer_tpu.nn.vn import MaskedBatchNorm
from buffer_tpu.ops import neighbors as jnbr

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.compat.from_jax import variables_to_state_dict
from buffer_tpu_torch.core import gridmath
from buffer_tpu_torch.data.preprocess import prepare_pair
from buffer_tpu_torch.kernels import cuda, geom_cuda
from buffer_tpu_torch.models import patch_embedder as pe
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.nn.vn import batch_norm
from buffer_tpu_torch.ops import neighbors
from buffer_tpu_torch.pipeline.train_forward import sample_matches

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(gp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _t(a):
    return torch.from_numpy(np.array(a))


def _prio(seed, n):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,),
                                         dtype=jnp.float32))


def _cloud(rs, B, N, Q):
    sup = rs.randn(B, N, 3).astype(np.float32)
    valid = rs.rand(B, N) > 0.15
    q = (rs.randn(B, Q, 3) * 0.5).astype(np.float32)
    return sup, valid, q


@pytest.mark.parametrize("Q", [13, 32])
def test_ball_sample_points_plain_matches_pallas(Q):
    """Bit-equal selection and coordinates, invalid support points and a
    query count that is not a multiple of the kernel's 8-query tile
    included; the port's invalid slots hold 0."""
    rs = np.random.RandomState(5)
    B, N, k, r = 2, 1024, 32, 0.8
    sup, valid, q = _cloud(rs, B, N, Q)
    prio = np.stack([_prio(10 + b, N) for b in range(B)])
    pts, v = geom_cuda.ball_sample_points_plain(_t(q), _t(sup), _t(valid),
                                                _t(prio), r, k)
    assert pts.shape == (B, Q, k, 3) and v.dtype == torch.bool
    for b in range(B):
        pj, vj = gp.ball_sample_points_tpu.__wrapped__(
            jax.random.PRNGKey(10 + b), jnp.asarray(q[b]), jnp.asarray(sup[b]),
            jnp.asarray(valid[b]), r, k)
        vj = np.asarray(vj)
        np.testing.assert_array_equal(v[b].numpy(), vj)
        np.testing.assert_array_equal(pts[b].numpy()[vj], np.asarray(pj)[vj])
        assert (pts[b].numpy()[~vj] == 0).all()
    assert v.any() and not v.all()
    # the wrapper takes the plain version on the CPU and launches nothing
    cuda.reset_launches()
    got = geom_cuda.ball_sample_points_cuda(_t(q), _t(sup), _t(valid),
                                            _t(prio), r, k)
    assert all(torch.equal(a, b) for a, b in zip(got, (pts, v)))
    assert cuda.launch_counts()["ball_sample_points"] == 0


def test_kernel_wrappers_refuse_gradients():
    """No kernel has a backward: an input that asks for a gradient raises
    rather than being cut from the graph."""
    rs = np.random.RandomState(6)
    sup, valid, q = _cloud(rs, 1, 256, 8)
    s = _t(sup).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        geom_cuda.ball_sample_points_cuda(_t(q), s, _t(valid),
                                          _t(_prio(1, 256))[None], 0.5, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        geom_cuda.nearest_cuda(_t(q), s, _t(valid))
    with torch.no_grad():
        geom_cuda.nearest_cuda(_t(q), s, _t(valid))


def _tpu_extract_patches(key, pts, pts_valid, kpts, des_r, patch_sample):
    gathered, valid = gp.ball_sample_points_tpu.__wrapped__(
        key, kpts, pts, pts_valid, float(des_r), patch_sample)
    patches = jnp.where(valid[..., None], gathered, kpts[:, None, :])
    return patches.at[:, -1, :].set(kpts)


@pytest.fixture(scope="module")
def patches():
    """Patches of two clouds by the port (one launch) and by JAX (the TPU
    branch of extract_patches, one cloud at a time)."""
    rs = np.random.RandomState(7)
    B, N, K, S, des_r = 2, 2048, 24, 64, 0.5
    pts = rs.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    pts[..., 2] = 0.3 * np.sin(3 * pts[..., 0]) + 0.2 * np.cos(2 * pts[..., 1])
    valid = rs.rand(B, N) > 0.05
    kpts = pts[:, rs.choice(N, K, replace=False)]
    keys = [jax.random.PRNGKey(30 + b) for b in range(B)]
    prio = np.stack([np.asarray(jax.random.uniform(k, (N,), dtype=jnp.float32))
                     for k in keys])
    got = pe.extract_patches(_t(pts), _t(valid), _t(prio), _t(kpts), des_r, S)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gp.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        want = np.stack([np.asarray(_tpu_extract_patches(
            keys[b], jnp.asarray(pts[b]), jnp.asarray(valid[b]),
            jnp.asarray(kpts[b]), des_r, S)) for b in range(B)])
    axes = rs.randn(B, K, 3).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    return got, want, axes


def test_extract_patches_matches_jax(patches):
    got, want, _ = patches
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dataset", ["3DMatch", "KITTI"])
def test_axis_align_and_so2_augment_match_jax(patches, dataset):
    got, want, axes = patches
    d, ra, R = pe.axis_align(got[0], dataset, _t(axes[0]))
    dj, raj, Rj = jpe.axis_align(jnp.asarray(want[0]), dataset,
                                 jnp.asarray(axes[0]))
    for a, b in ((d, dj), (ra, raj), (R, Rj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, (d.shape[0], 1)))[:, 0]
    for a, b in zip(pe.so2_augment(_t(u), d, ra),
                    jpe.so2_augment(key, dj, raj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_spt_and_var_to_invar_match_jax(patches):
    """The sampled SPT on aligned, scaled patches: the same samples (exact
    top-k of the same priorities; the ball test in the same expanded
    order), derotated to 1e-6."""
    got, _, axes = patches
    p = tconfig.tiny_cfg().patch
    delta, _, _ = pe.axis_align(got[1], "3DMatch", _t(axes[1]))
    delta = delta / 0.5
    key = jax.random.PRNGKey(9)
    prio = np.asarray(jax.random.uniform(key, (delta.shape[1],)))
    out = pe.spt(_t(prio), delta, p.rad_n, p.azi_n, p.ele_n,
                 p.delta / p.rad_n, p.voxel_sample, kpt_chunk=10)
    want = np.asarray(jpe.spt(key, jnp.asarray(delta.numpy()), p.rad_n,
                              p.azi_n, p.ele_n, p.delta / p.rad_n,
                              p.voxel_sample))
    assert out.shape == want.shape
    assert (out != 0).any(-1).sum() > 0.2 * out[..., 0].numel()
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)

    rs = np.random.RandomState(8)
    x = rs.randn(3, p.rad_n * p.ele_n * p.azi_n, 4, 3).astype(np.float32)
    R = jgridmath.azimuth_derotations(p.azi_n)
    np.testing.assert_allclose(
        gridmath.var_to_invar(_t(x), torch.as_tensor(R, dtype=torch.float32),
                              p.rad_n, p.azi_n, p.ele_n).numpy(),
        np.asarray(jgridmath.var_to_invar(jnp.asarray(x), jnp.asarray(R),
                                          p.rad_n, p.azi_n, p.ele_n)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_masked_batch_norm_train_matches_jax(masked):
    """Outputs, and the running mean and variance after the update
    (momentum 0.1, unbiased variance), with and without a mask; PyTorch's
    own unmasked batch norm in train mode has the same semantics."""
    rs = np.random.RandomState(11)
    x = (rs.randn(2, 50, 6, 8) * 2 + 0.5).astype(np.float32)
    mask = rs.rand(2, 50, 6) > 0.3 if masked else None
    bnj = MaskedBatchNorm(8)
    v = bnj.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"weight": rs.rand(8).astype(np.float32) + 0.5,
              "bias": rs.randn(8).astype(np.float32)}
    stats = {"mean": rs.randn(8).astype(np.float32),
             "var": rs.rand(8).astype(np.float32) + 0.5}
    y_j, upd = bnj.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x), None if mask is None else
                         jnp.asarray(mask), train=True, mutable=["batch_stats"])
    bn = torch.nn.BatchNorm1d(8)
    with torch.no_grad():
        bn.weight.copy_(_t(params["weight"]))
        bn.bias.copy_(_t(params["bias"]))
        bn.running_mean.copy_(_t(stats["mean"]))
        bn.running_var.copy_(_t(stats["var"]))
    bn.train()
    y = batch_norm(_t(x), bn, None if mask is None else _t(mask))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    if not masked:
        own = torch.nn.BatchNorm2d(8)
        own.load_state_dict({k: torch.tensor(v) for k, v in
                             {"weight": params["weight"], "bias": params["bias"],
                              "running_mean": stats["mean"],
                              "running_var": stats["var"],
                              "num_batches_tracked": 0}.items()})
        own.train()
        y2 = own(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(y2.detach().numpy(), np.asarray(y_j),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(own.running_var.numpy(),
                                   np.asarray(upd["batch_stats"]["var"]),
                                   rtol=1e-5, atol=1e-6)
    bn.eval()
    np.testing.assert_allclose(
        batch_norm(_t(x), bn).detach().numpy(),
        (x - bn.running_mean.numpy()) / np.sqrt(bn.running_var.numpy() + 1e-5)
        * params["weight"] + params["bias"], rtol=1e-5, atol=1e-5)


def _grads_vs_oracle(run, want):
    """Relative L2 distance of each gradient leaf from a float64 run of the
    port: (port fp32, JAX fp32) per leaf, leaves under 1e-3 of the largest
    measured against that floor."""
    oracle, port = run(torch.float64), run(torch.float32)
    top = max(np.linalg.norm(a) for a in oracle.values())
    rel = lambda a, o: np.linalg.norm(a - o) / max(np.linalg.norm(o), 1e-3 * top)
    return {k: (rel(port[k], o), rel(want[k], o)) for k, o in oracle.items()}


def test_cylindrical_train_gradients():
    """CylindricalNet in train mode: the fp32 gradients of both packages
    within 3e-2 of a float64 run of the port.  Neither is closer than
    ~8e-3 at conv3d_0 on this input: the train-mode gradient is
    ill-conditioned in fp32, which bounds how closely the port can follow
    JAX (ROADMAP.md section 3)."""
    from buffer_tpu.nn.cylindrical import CylindricalNet as JCyl
    from buffer_tpu_torch.nn.cylindrical import CylindricalNet
    rs = np.random.RandomState(0)
    x = rs.randn(8, 3, 7, 20, 16).astype(np.float32)
    w = rs.randn(8, 7, 20, 32).astype(np.float32)
    jc = JCyl()
    v = jax.tree_util.tree_map(np.asarray, jc.init(jax.random.PRNGKey(1),
                                                   jnp.asarray(x)))

    def loss_fn(params):
        out, _ = jc.apply({"params": params, "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out * w)

    g = jax.jit(jax.grad(loss_fn))(v["params"])
    sd = variables_to_state_dict({"Desc": {
        "params": {"conv_net": v["params"]},
        "batch_stats": {"conv_net": v["batch_stats"]}}})
    want = variables_to_state_dict({"Desc": {"params": {"conv_net": g}}})
    pre = "Desc.conv_net."
    want = {k[len(pre):]: np.asarray(a, np.float64) for k, a in want.items()
            if k.startswith(pre)}

    def run(dt):
        net = CylindricalNet()
        net.load_state_dict({k[len(pre):]: torch.tensor(a) for k, a in sd.items()
                             if k.startswith(pre)})
        net = net.to(dt).train()
        out = net(_t(x).to(dt).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 1)
        (out * _t(w).to(dt)).sum().backward()
        return {k: p.grad.double().numpy() for k, p in net.named_parameters()}

    errs = _grads_vs_oracle(run, want)
    assert max(max(e) for e in errs.values()) <= 3e-2, errs


def test_desc_train_gradients():
    """MiniSpinNet on sampled patches in train mode: the loss of JAX's to
    1e-5, and both packages' fp32 gradients within 5e-2 of a float64 run of
    the port.  Neither fp32 run is closer than ~5e-3: the max over each
    anchor's samples routes a gradient to whichever sample wins, and
    samples within rounding of each other win by rounding."""
    jm = JModel(jconfig.tiny_cfg())
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(12)
    inv = (rs.randn(16, 420, 10, 3) * 0.3).astype(np.float32)
    inv[:, :, 7:] = 0
    wd = rs.randn(16, 32).astype(np.float32)
    we = rs.randn(16, 7, 20, 32).astype(np.float32)

    def loss_fn(params):
        (d, e), _ = jm.Desc.apply({"params": params,
                                   "batch_stats": v["Desc"]["batch_stats"]},
                                  jnp.asarray(inv), train=True,
                                  mutable=["batch_stats"])
        return jnp.sum(d * wd) + jnp.sum(e * we)

    loss_j, g = jax.jit(jax.value_and_grad(loss_fn))(v["Desc"]["params"])
    want = variables_to_state_dict(
        {"Desc": {"params": jax.tree_util.tree_map(np.asarray, g)}})
    want = {k[len("Desc."):]: np.asarray(a, np.float64) for k, a in want.items()}
    sd = {k: torch.tensor(a) for k, a in variables_to_state_dict(v).items()}
    losses = {}

    def run(dt):
        model = BufferModel(tconfig.tiny_cfg())
        model.load_state_dict(sd)
        desc = model.Desc.to(dt).train()
        d, e = desc(inv_patches=_t(inv).to(dt))
        loss = (d * _t(wd).to(dt)).sum() + (e * _t(we).to(dt)).sum()
        loss.backward()
        losses[dt] = float(loss.detach())
        return {k: p.grad.double().numpy() for k, p in desc.named_parameters()}

    errs = _grads_vs_oracle(run, want)
    np.testing.assert_allclose(losses[torch.float32], float(loss_j), rtol=1e-5)
    assert max(e[0] for e in errs.values()) <= 5e-2, errs
    assert max(e[1] for e in errs.values()) <= 5e-2, errs


def _tpu_nearest(query, support, support_valid, chunk=8192, method="auto",
                 band=None, query_valid=None):
    if band is not None and 2 * band < support.shape[0]:
        return gp.banded_nn1_tpu.__wrapped__(query, support, support_valid,
                                             query_valid)
    return gp.nearest_tpu.__wrapped__(query, support, support_valid)


def _banded_plan(mod):
    c = mod.tiny_cfg()
    import dataclasses
    return c.replace(static=dataclasses.replace(
        c.static, points_l0=4096, points_l1=2048, points_l2=512,
        raw_points=4096, knn_band=512))


@pytest.mark.parametrize("plan", ["tiny", "banded"])
def test_sample_matches_matches_jax(monkeypatch, plan):
    """The same rows, targets and validity as JAX's sampler, with JAX's 1-NN
    held to the TPU kernels (``nearest_tpu``; ``banded_nn1_tpu`` behind the
    joint Morton sort on the banded plan).  Fewer in-radius rows than
    pos_num: the rest are invalid rows taken lowest index first."""
    monkeypatch.setattr(jtf, "nearest", _tpu_nearest)
    monkeypatch.setattr(jnbr, "nearest", _tpu_nearest)
    jcfg, tcfg = ((jconfig.tiny_cfg(), tconfig.tiny_cfg()) if plan == "tiny"
                  else (_banded_plan(jconfig), _banded_plan(tconfig)))
    n = 900 if plan == "tiny" else 4000
    rs = np.random.RandomState(13)
    raw = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    raw[:, 2] = 0.3 * np.sin(3 * raw[:, 0]) + 1.0
    c, s = np.cos(0.3), np.sin(0.3)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = [0.1, 0.0, -0.05]
    tgt = (raw @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    tgt = tgt[: int(0.7 * n)]              # partial overlap
    ji = jpre.prepare_pair(jcfg, raw.copy(), tgt.copy(),
                           rs=np.random.RandomState(1), already_downsampled=True)
    ti = prepare_pair(tcfg, raw.copy(), tgt.copy(), rs=np.random.RandomState(1),
                      already_downsampled=True, device="cpu")
    band = jcfg.static.knn_band
    if plan == "banded":
        assert 2 * band < ti.sds.shape[1]
    num = ti.sds.shape[1]
    key = jax.random.PRNGKey(3)
    mj = jtf.sample_matches(key, ji.sds[0], ji.sds_mask[0], ji.sds[1],
                            ji.sds_mask[1], jnp.asarray(T),
                            jcfg.data.voxel_size_0, num,
                            jcfg.static.knn_chunk, band=band)
    prio = _t(jax.random.uniform(key, (ti.sds.shape[1],)))
    m = sample_matches(prio, ti.sds[0], ti.sds_mask[0], ti.sds[1],
                       ti.sds_mask[1], _t(T), tcfg.data.voxel_size_0, num,
                       band=band)
    np.testing.assert_array_equal(m.src_idx.numpy(), np.asarray(mj.src_idx))
    np.testing.assert_array_equal(m.valid.numpy(), np.asarray(mj.valid))
    # the gt warp is a 3x3 matmul summed in another order (an ulp apart), so
    # a source point equidistant to rounding from two targets may take
    # either; every other target is the same
    tj, tt = np.asarray(mj.tgt_idx), m.tgt_idx.numpy()
    flip = np.nonzero(tj != tt)[0]
    assert len(flip) <= 0.01 * num, flip
    src = ti.sds[0].numpy()[m.src_idx.numpy()[flip]] @ T[:3, :3].T + T[:3, 3]
    d = [np.sum((src - ti.sds[1].numpy()[t[flip]]) ** 2, -1) for t in (tj, tt)]
    np.testing.assert_allclose(d[0], d[1], rtol=0, atol=1e-6)
    n_ok = int(m.valid.sum())
    assert 0 < n_ok < num and not m.valid[n_ok:].any()
    rest = m.src_idx[n_ok:].numpy()
    assert (np.diff(rest) > 0).all()


def test_morton_codes_match_jax():
    rs = np.random.RandomState(14)
    pts = rs.uniform(-2, 3, (500, 3)).astype(np.float32)
    valid = rs.rand(500) > 0.1
    lo, span = pts.min(0), pts.max(0) - pts.min(0)
    want = np.asarray(jnbr.morton_codes(jnp.asarray(pts), jnp.asarray(valid),
                                        jnp.asarray(lo), jnp.asarray(span)))
    got = neighbors.morton_codes(_t(pts), _t(valid), _t(lo), _t(span))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
