"""The trace readers and the metric readers on made-up inputs."""

import pytest

from benchmark.arith import flops, peaks, search
from benchmark.harness import manifest as mf
from benchmark.harness.window import Window
from benchmark.harness.trace import (Trace, classify, gaps, read_profile,
                                     span_at, union_s)

CLASSES = mf.load_kernel_classes()
M3 = mf.load_config(mf.load_manifest(), "3dmatch")["model"]


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert union_s(iv) == pytest.approx(3.0)
    assert gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]


@pytest.mark.parametrize("name,cls", [
    ("void bknn_kernel<16>(float4 const*)", "search.bknn"),
    ("bnn1_pack_kernel", "search.bnn1"),
    ("fps_cluster_kernel<8>", "search.fps"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32", "conv"),
    ("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float>", "norm"),
    ("ampere_sgemm_128x64_nn", "gemm"),
    ("void at::native::elementwise_kernel<128, 2>", "other"),
])
def test_classes(name, cls):
    assert classify(name, CLASSES) == cls


def test_read_profile_shares_and_gap_spans():
    ev = [("bench.program", 0.0, 10.0, False),
          ("bench.pose_read", 8.0, 10.0, False),
          ("fps_cluster_kernel", 1.0, 2.0, True),
          ("sm90_xmma_fprop_implicit_gemm", 2.0, 5.0, True),
          ("void at::native::foo", 4.0, 6.0, True),
          ("bknn_kernel", 20.0, 21.0, True)]          # outside the window
    tr = read_profile(ev, 0.0, 10.0, CLASSES, calls=1, pairs=3)
    assert tr.busy_s == pytest.approx(5.0)
    assert tr.class_s == pytest.approx({"search.fps": 1.0, "conv": 3.0,
                                        "other": 2.0})
    assert tr.device_ops[0][0].startswith("conv: ")
    labels = [g[0] for g in tr.idle_gaps]
    assert labels[0].startswith("bench.pose_read")    # the 4 s gap 6..10
    assert span_at([("a", 0, 10), ("b", 2, 3)], 2.5) == "b"


def _run(tr=None, **window):
    w = Window(**window)
    return {"window": w, "trace": tr, "config": {"model": M3},
            "peaks": peaks(), "classes": CLASSES, "traffic": {"loop": "groups"},
            "memory": {"reserved_peak": 3 * 2 ** 30}, "setup_s": 12.0}


def test_window_readers():
    run = _run(start=0.0, end=10.0, pairs=190)
    r = lambda n: mf.load_reader(n)(run)
    assert r("pairs_per_s") == pytest.approx(19.0)
    assert r("mfu.testset") == pytest.approx(
        100 * flops.model_flops(M3) * 19.0 / 67e12)
    assert r("peak_reserved_GiB.testset") == pytest.approx(3.0)
    assert r("setup_s") == 12.0
    assert r("conv_roofline.testset") is None      # untraced run
    assert r("device_ms_per_pair.testset") is None


def test_rooflines_and_idle_from_a_trace():
    least_conv = flops.conv_flops(M3) / 67e12
    bound = search.bound_s(M3, peaks())
    tr = Trace(window_s=1.0, busy_s=0.7, calls=2, pairs=6, kernels=[],
               class_s={"conv": 6 * least_conv / 0.3,
                        "search.fps": 6 * bound["search.fps"] / 0.02})
    run = _run(tr)
    r = lambda n: mf.load_reader(n)(run)
    assert r("conv_roofline.testset") == pytest.approx(30.0)
    # classes with no device time leave their work out
    assert r("search_roofline.testset") == pytest.approx(2.0)
    assert r("device_idle_share.testset") == pytest.approx(30.0)
    # device work only: the idle 0.3 s left out
    assert r("device_ms_per_pair.testset") == pytest.approx(700.0 / 6)


def test_readers_find_nothing_in_an_empty_run():
    run = _run(start=0.0, end=1.0)
    for n in ("pairs_per_s", "device_ms_per_pair.testset", "mfu.testset",
              "search_roofline.testset", "device_idle_share.testset"):
        assert mf.load_reader(n)(run) is None
