"""``scripts/diag_kitti.py`` of the port against the JAX script's
computation on the CPU: the script's LiDAR pair (``make_lidar_pair`` from
``RandomState(13)``) at the shrunk KITTI plan, random weights shared by
both packages and JAX's draws of ``PRNGKey(0)``, JAX held to the TPU
kernels' semantics as in ``test_torch_registration.py``.  The JAX script
reads the reference snapshot from a fixed path, so its figures are
computed here by its own lines on JAX's ``register_pair``."""

import functools
import os
import warnings

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

import buffer_tpu.config as jconfig
import buffer_tpu.kernels.geom_pallas as gp
from buffer_tpu.data import synthetic as jsyn
from buffer_tpu.models import patch_embedder as jpe
from buffer_tpu.models.composite import BufferModel as JModel
from buffer_tpu.pipeline.registration import register_pair as j_register_pair

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.compat.from_jax import variables_to_state_dict
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.scripts import diag_kitti

from test_torch_registration import (_fused_kernel_semantics, _jax_draws,
                                     _tpu_dispatch)

torch.set_num_threads(1)

STAGES = ("Ref", "Desc", "Keypt", "Inlier")


def _jax_script_figures(res, inter, T_gt):
    """``scripts/diag_kitti.py:33-64`` on JAX's result, as numbers."""
    kpts = np.asarray(inter["kpts"])
    m = inter["matches"]
    mutual = np.asarray(m.mutual)
    tgt_idx = np.asarray(m.tgt_idx)
    ss = kpts[0][mutual]
    tt = kpts[1][tgt_idx][mutual]
    R, t = T_gt[:3, :3], T_gt[:3, 3]
    d_true = np.linalg.norm(ss @ R.T + t - tt, axis=-1)
    d_alias = np.linalg.norm(ss @ R.T - tt, axis=-1)
    r_s = np.linalg.norm(ss[:, :2], axis=-1)
    al, tr = d_alias < 0.6, d_true < 0.6
    return {"mutual": int(mutual.sum()),
            "pose_t": np.asarray(res.pose)[:3, 3],
            "consistent": [(th, int(np.sum(d_true < th)),
                            int(np.sum(d_alias < th))) for th in (0.3, 0.6, 2.0)],
            "true_radius": np.median(r_s[tr]) if tr.sum() else None,
            "true_z": np.median(ss[tr][:, 2]) if tr.sum() else None,
            "alias_z": np.median(ss[al][:, 2]) if al.sum() else None}


def test_diag_kitti_matches_jax_script(monkeypatch):
    """The mutual count and every threshold's true- and alias-consistent
    counts equal JAX's; the pose's translation within 1e-3 and the median
    radius and heights within 1e-4 (the tolerances of
    ``test_torch_registration.py``)."""
    monkeypatch.setattr(gp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jpe, "fused_point_features", _fused_kernel_semantics)
    _tpu_dispatch(monkeypatch)
    jcfg = jconfig.shrink_static(jconfig.make_cfg("KITTI"))
    tcfg = tconfig.shrink_static(tconfig.make_cfg("KITTI"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        inputs, T_gt = jsyn.make_lidar_pair(jcfg, np.random.RandomState(13))
    jm = JModel(jcfg)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(0)
    res, inter = jax.jit(lambda v, i, k: j_register_pair(
        jm, v, i, k, return_intermediates=True))(variables, inputs, key)
    want = _jax_script_figures(res, inter, T_gt)

    model = BufferModel(tcfg)
    model.load_state_dict({k: torch.tensor(v) for k, v in variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)).items()})
    got = diag_kitti.run(model.eval(), tcfg, draws=_jax_draws(key, jcfg),
                         device="cpu")
    assert got["mutual"] == want["mutual"] > 0
    assert got["consistent"] == want["consistent"]
    np.testing.assert_allclose(got["pose_t"], want["pose_t"], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(got["gt_t"], T_gt[:3, 3])
    for k in ("true_radius", "true_z", "alias_z"):
        assert (got[k] is None) == (want[k] is None), k
        if want[k] is not None:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4)
    lines = diag_kitti.report(got)
    assert lines[0].startswith(f"mutual={want['mutual']}  pose_t=")
    assert len(lines) == 2 + len(diag_kitti.THRESHOLDS) + 3


@pytest.fixture
def snapshot(tmp_path):
    """Seeded random weights at the shrunk KITTI plan as a reference
    snapshot."""
    sd = BufferModel(tconfig.shrink_static(tconfig.kitti_cfg()), seed=3).state_dict()
    for s in STAGES:
        os.makedirs(tmp_path / "snap" / s)
        torch.save(sd, tmp_path / "snap" / s / "best.pth")
    return str(tmp_path / "snap")


def test_diag_kitti_main_prints_and_needs_weights(snapshot, tmp_path, capsys):
    """``main --tiny --device cpu`` with a snapshot prints the JAX script's
    lines; a missing snapshot or checkpoint directory raises, never falling
    back to random weights."""
    args = ["--tiny", "--device", "cpu"]
    assert diag_kitti.main([*args, "--torch-weights", snapshot]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("mutual=")
    assert [ln.split(":")[0] for ln in out[1:4]] == ["th=0.3", "th=0.6",
                                                     "th=2.0"]
    with pytest.raises(FileNotFoundError):
        diag_kitti.main([*args, "--reference-root", str(tmp_path)])
    with pytest.raises(FileNotFoundError):
        diag_kitti.main([*args, "--weights", str(tmp_path / "none")])
