"""mfu.testset (whole program on the device, %): the model's operations a
pair (benchmark/arith/flops.py's ``model_flops`` at the configuration's
shapes) times the window's pairs, over the window's seconds, as a share of
the card's fp32 peak."""

from benchmark.arith import flops


def read(run):
    w = run["window"]
    if not w.pairs:
        return None
    rate = flops.model_flops(run["config"]["model"]) * w.pairs / w.seconds
    return 100.0 * rate / run["peaks"]["fp32_flops_per_s"]
