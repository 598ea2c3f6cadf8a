"""search_roofline.testset (search kernels, %): the summed least times of
the search kernels' work over the traced pairs (benchmark/arith/search.py)
over their summed device time, by the classes of ``kernel_classes.json``.
A class with no device time (a kernel taken off the path) leaves its work
out too."""

from benchmark.arith import search


def read(run):
    tr = run["trace"]
    if tr is None or not tr.pairs:
        return None
    bound = search.bound_s(run["config"]["model"], run["peaks"])
    least = t = 0.0
    for c in run["classes"]["rooflines"]["search"]:
        if tr.class_s.get(c, 0.0) > 0 and c in bound:
            least += bound[c] * tr.pairs
            t += tr.class_s[c]
    return 100.0 * least / t if t > 0 else None
