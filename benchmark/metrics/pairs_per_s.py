"""pairs_per_s (end to end, host clock): every pair whose pose reached the
host in the window, over the window's seconds (from its start to the end
of the last call started inside it)."""


def read(run):
    w = run["window"]
    return w.pairs / w.seconds if w.pairs else None
