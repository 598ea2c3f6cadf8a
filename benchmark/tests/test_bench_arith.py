"""The arithmetic reproduces the port's measured counts."""

import pytest

from benchmark.arith import flops, peaks, search
from benchmark.harness import manifest as mf

M3 = mf.load_config(mf.load_manifest(), "3dmatch")["model"]
MK = mf.load_config(mf.load_manifest(), "kitti")["model"]


def test_conv_flops_match_profile_micro():
    # profile_micro: cylindrical 0.356 TFLOP, CostNet 0.240 a 3DMatch pair
    assert flops.cylindrical_flops(M3) == pytest.approx(0.356e12, rel=2e-3)
    assert flops.costnet_flops(M3) == pytest.approx(0.240e12, rel=2e-3)
    # the largest convolution of each (PERF.md: 7.488 ms at 25% of 67 TF)
    assert max(flops.cylindrical_layers(M3)) == 2 * 3000 * 128 * 140 * 128 * 9


def test_model_flops_bound_the_convolutions():
    for m in (M3, MK):
        assert flops.conv_flops(m) < flops.model_flops(m) < 1.05 * flops.conv_flops(m)


def test_search_bounds_match_the_kernel_table():
    # PERF.md's section 6 bounds (ms a 3DMatch pair): bknn 0.106 (889 M
    # window tests), bnn1 0.0150, nearest 0.00751, FPS 0.0124, ball 0.0205
    b = {k: 1e3 * v for k, v in search.bound_s(M3, peaks()).items()}
    assert b["search.bknn"] == pytest.approx(0.106, rel=5e-3)
    assert b["search.bnn1"] == pytest.approx(0.0150, rel=5e-3)
    assert b["search.nearest"] == pytest.approx(0.00751, rel=5e-3)
    assert b["search.fps"] == pytest.approx(0.0124, rel=5e-3)
    assert b["search.ball"] == pytest.approx(0.0205, rel=5e-3)
    bknn = [c for c in search.calls(M3) if c[0] == "search.bknn"]
    assert sum(2 * q * w for _, q, _, w, _ in bknn) == 889_192_448


def test_kitti_routes():
    # KITTI: 5 banded kNN calls (level 2's window covers its grid), the
    # banded 1-NN at level 0 and the exact 1-NN at level 1
    kinds = [c[0] for c in search.calls(MK)]
    assert kinds.count("search.bknn") == 5
    assert kinds.count("search.bnn1") == 1 and kinds.count("search.nearest") == 1
