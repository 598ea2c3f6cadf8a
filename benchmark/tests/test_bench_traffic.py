"""The traffic generator: the same seed gives the same inputs."""

import numpy as np
import pytest
import torch

from benchmark.harness import manifest as mf
from benchmark.harness.traffic import Traffic, random_state, torch_seed

BIG = 2 ** 33 + 12345


@pytest.mark.parametrize("mix", ["room_testset", "lidar_testset"])
def test_pairs_are_deterministic_by_seed(mix):
    m = mf.load_traffic(mix)
    a, b, c = Traffic(m, BIG), Traffic(m, BIG), Traffic(m, BIG + 1)
    pa, pb, pc = a.raw_pair(1), b.raw_pair(1), c.raw_pair(1)
    assert np.array_equal(pa.src, pb.src) and np.array_equal(pa.T, pb.T)
    assert not np.array_equal(pa.T, pc.T)
    assert list(a.order) == list(b.order)
    assert a.checked_requests() == b.checked_requests()
    assert all(0 <= r < m["check"]["among"] for r in a.checked_requests())


def test_draws_are_deterministic_by_seed_and_request():
    from buffer_tpu_torch.config import tiny_cfg
    from buffer_tpu_torch.pipeline.registration import Draws
    m = mf.load_traffic("room_testset")
    t = Traffic(m, BIG)
    d1 = t.draws(tiny_cfg(), 5, torch.device("cpu"), Draws)
    d2 = t.draws(tiny_cfg(), 5, torch.device("cpu"), Draws)
    d3 = t.draws(tiny_cfg(), 6, torch.device("cpu"), Draws)
    assert torch.equal(d1.ransac_gumbel, d2.ransac_gumbel)
    assert not torch.equal(d1.ball_prio, d3.ball_prio)


def test_seed_streams_take_any_whole_seed():
    assert random_state(2 ** 40, 1).rand() != random_state(2 ** 40 + 1, 1).rand()
    assert 0 <= torch_seed(2 ** 31 + 5, 3, 7) < 2 ** 63
    with pytest.raises(ValueError):
        random_state(-1)


def test_spread_arguments_are_the_same_for_every_seed(monkeypatch):
    import types

    from benchmark.harness import manifest
    seen = []
    scene = types.SimpleNamespace(
        make=lambda rs, **kw: seen.append(kw["overlap"]) or (0, 0, 0))
    monkeypatch.setattr(manifest, "load_module", lambda kind, name: scene)
    m = mf.load_traffic("room_testset")
    for seed in (3, 4):
        Traffic(m, seed).pool()
    n = m["pool"]
    lo, hi = m["spread"]["overlap"]
    want = [lo + (hi - lo) * (j + 0.5) / n for j in range(n)]
    assert seen == want + want


def test_weights_are_drawn_from_the_seed():
    import math

    from benchmark.harness.weights import make_state_dict
    from benchmark.reference.buffer import parameter_layout, settings
    conf = mf.load_config(mf.load_manifest(), "3dmatch")
    layout = parameter_layout(settings(conf))
    spec = {"seed": 4, "perturbation": 0.01}
    a = make_state_dict(layout, BIG, torch.device("cpu"), spec)
    b = make_state_dict(layout, BIG, torch.device("cpu"), spec)
    c = make_state_dict(layout, BIG + 1, torch.device("cpu"), spec)
    assert list(a) == [k for k, _, _ in layout]
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "Desc.conv_net.ops.0.weight"
    assert not torch.equal(a[w], c[w])
    ratio = (a[w] / c[w]).flatten()
    assert float((ratio - 1).abs().max()) < 0.021   # one model, perturbed
    bound = math.sqrt(6.0 / (16 * 27)) * 1.01
    assert float(a[w].abs().max()) <= bound and float(a[w].abs().max()) > 0.9 * bound
    assert float(a["Desc.conv_net.ops.0.bias"].abs().max()) == 0.0
    assert torch.equal(a["Desc.pnt_layer.1.running_var"], torch.ones(16))


@pytest.mark.parametrize("preset", ["3DMatch", "KITTI"])
def test_the_layout_is_the_models(preset):
    """The port's model loads the benchmark's state dict strictly, key for
    key in its own order."""
    from benchmark.harness.weights import make_state_dict
    from benchmark.reference.buffer import parameter_layout, settings
    from buffer_tpu_torch.config import make_cfg
    from buffer_tpu_torch.models.composite import BufferModel
    name = {"3DMatch": "3dmatch", "KITTI": "kitti"}[preset]
    conf = mf.load_config(mf.load_manifest(), name)
    layout = parameter_layout(settings(conf))
    model = BufferModel(make_cfg(preset))
    assert [k for k, _, _ in layout] == list(model.state_dict())
    model.load_state_dict(make_state_dict(layout, 3, torch.device("cpu"),
                                          conf["weights"]), strict=True)
