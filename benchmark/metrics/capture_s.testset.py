"""capture_s.testset (registration program, s): the program's counter
``register.capture_s``, the host seconds of the first call of each input
signature (each chain's eager warm-up and its graph captures), summed
over the process: part of set-up."""

from benchmark.harness import records


def read(run):
    return records.counter("register.capture_s")
