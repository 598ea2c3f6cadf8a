"""call_gap_ms.testset (registration program, ms a call): the mean over the
untraced window's calls of the program's ``call_gap_ms``, from the
previous call's call_end, recorded on the caller's stream after the
outputs are stacked, to this call's call_start: the caller's read of the
poses and its work between two calls (none for the first call after a
capture). Plain timing events outside the graphs."""

from benchmark.harness import records


def read(run):
    return records.call_ms(run, "call_gap_ms")
