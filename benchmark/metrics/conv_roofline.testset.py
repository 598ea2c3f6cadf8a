"""conv_roofline.testset (convolutions, %): the least time of the
cylindrical CNN's and CostNet's operations (benchmark/arith/flops.py's
``conv_flops``) over the traced pairs at the fp32 peak, over the device
time of the kernels that ``kernel_classes.json`` classes as ``conv``."""

from benchmark.arith import flops


def read(run):
    tr = run["trace"]
    if tr is None or not tr.pairs:
        return None
    names = run["classes"]["rooflines"]["conv"]
    t = sum(tr.class_s.get(c, 0.0) for c in names)
    if t <= 0:
        return None
    least = flops.conv_flops(run["config"]["model"]) * tr.pairs \
        / run["peaks"]["fp32_flops_per_s"]
    return 100.0 * least / t
