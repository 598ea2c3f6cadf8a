"""tail_gap_ms.testset (registration program, ms a call): the mean over
the untraced window's calls of the program's ``tail_gap_ms``: from
fronts_done, a timing event on the caller's stream after the chains'
fronts are joined, to the first chain's tail_start, the first mark of its
tail graph: the card's wait on the host's read of the mutual counts and
the tail's launch."""

from benchmark.harness import records


def read(run):
    return records.call_ms(run, "tail_gap_ms")
