"""The compiled registration program: ``make_register_fn`` of the port
against the eager ``register_pair`` and against the JAX package's
``make_register_fn`` (its ``jax.jit`` of ``register_pair``) at the tiny
plan, and the capture-safety guard of the parts that the card captures as
CUDA graphs (:func:`pair_front` and :func:`pair_tail` of each budget).

On the CPU ``fn`` runs the front and tail eagerly, so it must equal
``register_pair`` bit for bit; JAX is held to the TPU kernels' semantics
as ``tests/test_torch_registration.py`` holds it (Pallas in interpret
mode), with that file's tolerances.  The card's side (graphs bit-equal to
eager, the boost tail, results that survive the next call, swapped
parameters) is in ``tests/test_torch_cuda.py``."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
from jax.experimental import pallas as pl

import buffer_tpu.config as jconfig
import buffer_tpu.kernels.geom_pallas as gp
from buffer_tpu.models import patch_embedder as jpe
from buffer_tpu.models.composite import BufferModel as JModel
from buffer_tpu.pipeline.registration import make_register_fn as j_make_register_fn

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.compat.from_jax import variables_to_state_dict
from buffer_tpu_torch.core import graphs
from buffer_tpu_torch.data.preprocess import prepare_pair
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.pipeline import registration
from buffer_tpu_torch.pipeline.registration import (Draws, make_draws,
                                                    make_register_fn,
                                                    register_pair)

from test_torch_registration import (_fused_kernel_semantics, _inputs_both,
                                     _jax_draws, _surface, _tpu_dispatch)

torch.set_num_threads(1)


def _boost(mod, th):
    """The tiny plan with the low-match budget on and threshold ``th``: 0
    keeps every pair on the base tail, 10**6 sends every pair to the boost
    tail."""
    c = mod.tiny_cfg()
    return c.replace(static=dataclasses.replace(c.static, low_match_boost=True,
                                                low_match_th=th))


def _kitti(mod):
    return mod.shrink_static(mod.kitti_cfg())


CASES = {
    "3DMatch boost taken": (lambda m: _boost(m, 10 ** 6), 1.0, True),
    "3DMatch boost not taken": (lambda m: _boost(m, 0), 1.0, False),
    "KITTI": (_kitti, 10.0, False),
}


def _assert_results_equal(got, want):
    for name in registration.RegistrationResult._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("case", list(CASES))
def test_program_matches_eager_and_jax(monkeypatch, case):
    """``make_register_fn(model, device="cpu")`` equals ``register_pair``
    bit for bit and agrees with JAX's ``make_register_fn``: keypoints and
    their validity, the mutual and RANSAC inlier counts exactly, the pose
    within 1e-3 (the tolerances of ``tests/test_torch_registration.py``)."""
    make, scale, boost = CASES[case]
    jcfg, tcfg = make(jconfig), make(tconfig)
    monkeypatch.setattr(gp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jpe, "fused_point_features", _fused_kernel_semantics)
    _tpu_dispatch(monkeypatch)
    raw = _surface(900, 0, extent=0.6 * scale)
    tgt = raw + np.float32([0.02, -0.01, 0.015]) * np.float32(scale)
    j_inputs, t_inputs = _inputs_both(jcfg, tcfg, raw, tgt)

    jm = JModel(jcfg)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0))
    model = BufferModel(tcfg)
    model.load_state_dict({k: torch.tensor(v) for k, v in variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)).items()})
    model.eval()

    key = jax.random.PRNGKey(7)
    res_j = j_make_register_fn(jm)(variables, j_inputs, key)
    draws = _jax_draws(key, jcfg)
    if tcfg.static.low_match_boost:
        # JAX's boost branch draws 4x the hypotheses from the same key
        # (ransac.py:43: categorical over gumbel(key, (4H, 3, K)))
        _, _, _, k_ransac = jax.random.split(key, 4)
        gumbel = jax.random.gumbel(k_ransac, (4 * jcfg.match.hypotheses, 3,
                                              jcfg.point.num_keypts))
        draws = draws._replace(
            ransac_gumbel_boost=torch.from_numpy(np.array(gumbel)))

    res = make_register_fn(model, device="cpu")(t_inputs, draws)
    _assert_results_equal(res, register_pair(model, t_inputs, draws,
                                             device="cpu"))
    assert registration.boost_taken(tcfg, res.num_mutual) == boost

    np.testing.assert_array_equal(res.kpt_valid.numpy(), np.asarray(res_j.kpt_valid))
    np.testing.assert_array_equal(res.kpts.numpy(), np.asarray(res_j.kpts))
    assert res.kpt_valid.any()
    assert int(res.num_mutual) == int(res_j.num_mutual) > 0
    assert int(res.num_inliers) == int(res_j.num_inliers)
    np.testing.assert_allclose(res.pose.numpy(), np.asarray(res_j.pose),
                               rtol=1e-3, atol=1e-3)


class HostTraffic(TorchDispatchMode):
    """Records every dispatched operator that a CUDA graph capture cannot
    hold: a read back to the host (``_local_scalar_dense``), a tensor built
    from host data (``lift_fresh``), ``nonzero``, an index by a boolean
    mask (its shape depends on the data), and ``segment_reduce`` with its
    length check (a host read)."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        bad = name in ("_local_scalar_dense", "lift_fresh", "lift_fresh_copy",
                       "nonzero")
        if name == "index":
            bad = any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                      for i in args[1] if i is not None)
        if name == "segment_reduce":
            bad = not kwargs.get("unsafe", False)
        if bad:
            self.found.append(str(func))
        return func(*args, **kwargs)


def _plan(mod, name):
    c = mod.tiny_cfg()
    static = dict(low_match_boost=True, low_match_th=10 ** 6)
    if name == "KITTI":
        c = _kitti(mod)
    elif name == "banded":
        static.update(points_l0=4096, points_l1=2048, points_l2=512,
                      raw_points=4096, knn_band=512)
    elif name == "fused_desc=False":
        static.update(fused_desc=False)
    return c.replace(static=dataclasses.replace(c.static, **static))


@pytest.mark.parametrize("name", ["3DMatch", "KITTI", "banded",
                                  "fused_desc=False", "device levels"])
def test_front_and_tails_are_capture_safe(name):
    """The front and every tail, with the kernels' plain versions, make no
    host read, build no tensor from host data and take no data-dependent
    shape: what a CUDA graph capture would refuse or bake in.  As on the
    card, an eager run comes first (the warm-up, which makes the per-device
    constants); the guarded run is the one that would be captured.  The
    boost decision's one host read lies between front and tail, outside
    the guarded parts."""
    cfg = _plan(tconfig, name)
    n = cfg.static.points_l0 + 400
    raw = _surface(n, 1, extent=1.0 if name == "banded" else 0.6)
    inputs = prepare_pair(cfg, raw, raw + np.float32([0.02, -0.01, 0.015]),
                          rs=np.random.RandomState(3),
                          already_downsampled=True, device="cpu")
    if name == "device levels":
        inputs = inputs._replace(lvl1=None, lvl1_mask=None, lvl2=None,
                                 lvl2_mask=None)
    model = BufferModel(cfg, seed=0).eval()
    draws = make_draws(cfg, torch.Generator().manual_seed(0), "cpu")
    budgets = (False, True) if cfg.static.low_match_boost else (False,)

    def run():
        with torch.no_grad():
            front, inter = registration.pair_front(model, inputs, draws)
            tails = [registration.pair_tail(
                cfg, front, *registration.tail_budget(cfg, draws, b))
                for b in budgets]
        return front, tails

    run()
    with HostTraffic() as traffic:
        front, tails = run()
    assert traffic.found == []
    assert int(front.num_mutual) > 0
    assert all(torch.isfinite(pose).all() for pose, _ in tails)


def _pair(cfg, seed):
    raw = _surface(900, seed)
    return prepare_pair(cfg, raw, raw + np.float32([0.02, -0.01, 0.015]),
                        rs=np.random.RandomState(3), already_downsampled=True,
                        device="cpu")


def test_program_result_survives_next_call():
    """A result of call i keeps its values through call i+1 on another
    pair with other draws."""
    cfg = _boost(tconfig, 10 ** 6)
    model = BufferModel(cfg, seed=0).eval()
    fn = make_register_fn(model, device="cpu")
    gen = torch.Generator().manual_seed(0)
    first = fn(_pair(cfg, 0), make_draws(cfg, gen, "cpu"))
    kept = graphs.clone(first)
    second = fn(_pair(cfg, 4), make_draws(cfg, gen, "cpu"))
    _assert_results_equal(first, kept)
    assert not torch.equal(first.kpts, second.kpts)


def test_program_intermediates_match_register_pair():
    """``return_intermediates=True``: the result and every tensor of the
    intermediates dict equal ``register_pair``'s."""
    cfg = tconfig.tiny_cfg()
    model = BufferModel(cfg, seed=0).eval()
    inputs = _pair(cfg, 0)
    draws = make_draws(cfg, torch.Generator().manual_seed(1), "cpu")
    res, inter = make_register_fn(model, device="cpu",
                                  return_intermediates=True)(inputs, draws)
    want_res, want = register_pair(model, inputs, draws, device="cpu",
                                   return_intermediates=True)
    _assert_results_equal(res, want_res)
    assert inter.keys() == want.keys()
    flat = lambda x: (list(torch.utils._pytree.tree_leaves(x)))
    for name in want:
        got_l, want_l = flat(inter[name]), flat(want[name])
        assert len(got_l) == len(want_l) > 0, name
        assert all(torch.equal(a, b) for a, b in zip(got_l, want_l)), name


@pytest.mark.parametrize("return_intermediates", [False, True])
def test_register_fn_is_the_one_pair_group(return_intermediates):
    """``make_register_fn`` is ``make_unrolled_register_fn`` at U = 1 with
    the leading axis dropped: on the CPU its result (and intermediates)
    equal the one-pair group's at index 0 and ``register_pair``'s, bit for
    bit."""
    cfg = tconfig.tiny_cfg()
    model = BufferModel(cfg, seed=0).eval()
    inputs = _pair(cfg, 0)
    draws = make_draws(cfg, torch.Generator().manual_seed(3), "cpu")
    kw = {"device": "cpu", "return_intermediates": return_intermediates}
    got = make_register_fn(model, **kw)(inputs, draws)
    group = registration.make_unrolled_register_fn(model, 1, **kw)(
        [inputs], [draws])
    want = register_pair(model, inputs, draws, **kw)
    leaves = torch.utils._pytree.tree_leaves
    got_l, group_l, want_l = leaves(got), leaves(group), leaves(want)
    assert len(got_l) == len(group_l) == len(want_l) > 0
    for a, g, w in zip(got_l, group_l, want_l):
        assert g.shape == (1, *a.shape)
        assert a.dtype == g.dtype == w.dtype
        assert torch.equal(a, g[0]) and torch.equal(a, w)


def test_clone_copies_every_tensor_of_a_nest():
    """The program's output copy: every tensor of nested named tuples,
    tuples and dicts is a new tensor with equal values; None stays."""
    t = torch.arange(6.0).reshape(2, 3)
    nest = {"a": Draws(t, t[0], t, None), "b": (t, [1, 2]), "c": 3}
    out = graphs.clone(nest)
    assert isinstance(out["a"], Draws) and out["a"].ransac_gumbel_boost is None
    assert torch.equal(out["a"].ball_prio, t)
    assert out["a"].ball_prio.data_ptr() != t.data_ptr()
    assert out["b"][0].data_ptr() != t.data_ptr() and out["b"][1] == [1, 2]
    assert out["c"] == 3


def test_program_defaults_to_the_card():
    """Without a device ``make_register_fn`` asks for the card: it raises
    where none is present and never falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_register_fn(BufferModel(tconfig.tiny_cfg(), seed=0).eval())
