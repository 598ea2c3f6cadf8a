"""The plain reference against the port on the CPU, where the port runs its
kernels' plain versions: host prep agrees bit for bit, and registration,
which the reference computes in float64 on its own code, agrees stage by
stage to float32 rounding, with the same keypoints, matches and poses."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from benchmark.harness import manifest as mf
from benchmark.harness.configs import port_config
from benchmark.harness.traffic import Traffic
from benchmark.harness.weights import make_state_dict
from benchmark.reference import buffer as B
from benchmark.reference import prep

SPEC = {"seed": 1, "perturbation": 0.01}
MIX = {"3DMatch": "room_testset", "KITTI": "lidar_testset"}


@pytest.mark.parametrize("cell", ["3dmatch.testset", "kitti.testset"])
def test_host_prep_matches_at_the_full_plan(cell):
    from buffer_tpu_torch.data.preprocess import prepare_pair
    man = mf.load_manifest()
    w = mf.workload(man, cell)
    conf = mf.load_config(man, w["config"])
    mix = mf.load_traffic(w["traffic"])
    t = Traffic(mix, 2 ** 32 + 3)
    raw = t.raw_pair(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = prepare_pair(port_config(conf), raw.src.copy(), raw.tgt.copy(),
                         rs=t.prep_state(0),
                         already_downsampled=mix["already_downsampled"],
                         device="cpu")
    b = prep.prepare_pair(B.settings(conf), raw.src.copy(), raw.tgt.copy(),
                          t.prep_state(0), mix["already_downsampled"])
    for k, v in b.items():
        assert np.array_equal(getattr(a, k).numpy(), v), k


def test_voxel_grid_first_seen_order_and_barycentres():
    pts = np.array([[0.05, 0, 0], [0.5, 0, 0], [0.07, 0.01, 0]], np.float32)
    out = prep.voxel_subsample(pts, 0.1)
    assert np.allclose(out, [[0.06, 0.005, 0], [0.5, 0, 0]])


def _pair(preset, seed):
    """The port's registration of a miniature pair with its stages, and the
    reference's inputs for the same pair, weights and draws."""
    from buffer_tpu_torch.config import make_cfg, shrink_static
    from buffer_tpu_torch.data.preprocess import prepare_pair
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.pipeline import registration as PR
    tree = dataclasses.asdict(shrink_static(make_cfg(preset)))
    tree.pop("train")
    tree.pop("optim")
    conf = {"preset": preset, "model": tree}
    cfg, s = port_config(conf), B.settings(conf)
    dev = torch.device("cpu")
    state = make_state_dict(B.parameter_layout(s), seed, dev, SPEC)
    model = BufferModel(cfg)
    model.load_state_dict(state, strict=True)
    model.eval()
    mix = mf.load_traffic(MIX[preset])
    t = Traffic(mix, seed)
    raw = t.raw_pair(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        inputs = prepare_pair(cfg, raw.src.copy(), raw.tgt.copy(),
                              rs=t.prep_state(0),
                              already_downsampled=mix["already_downsampled"],
                              device=dev)
    rin = prep.prepare_pair(s, raw.src.copy(), raw.tgt.copy(),
                            t.prep_state(0), mix["already_downsampled"])
    res, inter = PR.register_pair(model, inputs, t.draws(cfg, 0, dev, PR.Draws),
                                  device=dev, return_intermediates=True)
    ref = B.Reference(conf, state, dev)
    return res, inter, ref, rin, t.draws(s, 0, dev, B.Draws)


@pytest.mark.parametrize("preset", ["3DMatch", "KITTI"])
def test_registration_matches_the_port(preset):
    res, _, ref, rin, draws = _pair(preset, 11)
    out = ref.register(rin, draws)
    assert torch.equal(out["kpts"], res.kpts)
    assert torch.equal(out["kpt_valid"], res.kpt_valid)
    assert int(out["num_mutual"]) == int(res.num_mutual)
    assert int(out["num_inliers"]) == int(res.num_inliers)
    assert float((out["pose"] - res.pose.double()).abs().max()) < 1e-4


@pytest.mark.parametrize("preset,seed", [("3DMatch", 5), ("KITTI", 6)])
def test_stages_match_the_port(preset, seed):
    """Each stage of the reference on the port's own inputs to it: the
    tables equal, the float64 values within float32 rounding."""
    _, inter, ref, rin, draws = _pair(preset, seed)
    s, net = ref.s, ref.net
    a = {k: torch.as_tensor(v) for k, v in rin.items()}
    m = a["sds_mask"]
    pyr = B.pyramid(s, a["sds"], m, a["lvl1"], a["lvl1_mask"], a["lvl2"],
                    a["lvl2_mask"], torch.float64)
    P = inter["pyramid"]
    gap = lambda x, y: float((x - y.double()).abs().max())
    assert gap(pyr.normals[m], P.features[m]) < 1e-4
    for lvl in range(3):
        idx, ok = pyr.nbr[lvl]
        assert torch.equal(ok, P.neighbor_valid[lvl])
        assert torch.equal(idx.long()[ok], P.neighbors[lvl].long()[ok])
    axis, score = B.axes_and_saliency(net, s, pyr)
    assert gap(axis[m], inter["axis"][m]) < 1e-3
    assert gap(score[m], inter["score"][m]) < 1e-4
    K = inter["kpts"].shape[1]
    desc, equi, R = B.describe(net, s, draws, a["raw"], a["raw_mask"],
                               inter["kpts"], B.gather(axis, inter["kidx"]),
                               torch.float64)
    assert gap(desc[:K], inter["s_des"]) < 1e-4
    assert gap(desc[K:], inter["t_des"]) < 1e-4
    assert gap(equi[:K], inter["s_equi"]) < 1e-3
    assert gap(R[:K], inter["s_R"]) < 1e-3
    fwd, ok = B.mutual(desc[:K], desc[K:], inter["kvalid"][0],
                       inter["kvalid"][1])
    assert torch.equal(ok, inter["matches"].mutual)
    ind = B.azimuths(net, s, equi[:K], equi[K:][fwd])
    assert gap(ind, inter["azi_ind"]) < 1e-3


def test_horn_fit_recovers_a_motion():
    g = torch.Generator().manual_seed(3)
    A = torch.rand(1, 50, 3, generator=g, dtype=torch.float64)
    T = torch.eye(4, dtype=torch.float64)
    T[:3, :3] = torch.linalg.qr(torch.rand(3, 3, generator=g,
                                           dtype=torch.float64))[0]
    if torch.linalg.det(T[:3, :3]) < 0:
        T[:3, :3] = -T[:3, :3]
    T[:3, 3] = torch.tensor([0.3, -1.0, 2.0], dtype=torch.float64)
    assert torch.allclose(B.horn(A, A @ T[:3, :3].t() + T[:3, 3])[0], T,
                          atol=1e-8)
