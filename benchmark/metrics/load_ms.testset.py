"""load_ms.testset (registration program, ms a call): the mean over the
untraced window's calls of the program's ``load_ms``: from call_start, a
timing event on the caller's stream at the call's entry, to the last
chain's front_start, the first mark of its front graph, recorded on its
stream as the graph begins: the state check, the pairs' copies from
pageable host memory into the static buffers and the fronts' launches."""

from benchmark.harness import records


def read(run):
    return records.call_ms(run, "load_ms")
