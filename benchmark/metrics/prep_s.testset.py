"""prep_s.testset (host prep, s): the program's counter ``prep.s``, the
host seconds spent in ``data/preprocess.prepare_pair``, summed over the
process: the test-set loops prepare their pool in set-up."""

from benchmark.harness import records


def read(run):
    return records.counter("prep.s")
