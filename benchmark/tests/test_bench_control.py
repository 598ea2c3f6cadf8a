"""The control and the faults on the card, at the cell's own size: the
plain reference in TF32 (the next precision below the configuration's
float32 with TF32 off) in the program's place, and the program's answers
broken as :mod:`benchmark.calibrate` breaks them, each have to come out as
not correct under the configuration's limits, while the program's own
answers are correct.  Needs the card (``-m cuda``)."""

import pytest

from benchmark import calibrate, run as R
from benchmark.harness import manifest as mf

MAN = mf.load_manifest()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_control_and_faults_fail(card, cell):
    res = R.run_cell(MAN, mf.workload(MAN, cell), 2 ** 33 + 21, 3.0, False,
                     card, keep_back=3, study=calibrate.study)
    v = res["study"]["verdicts"]
    assert v["sound"], res["checks"]
    assert not any(ok for k, ok in v.items() if k != "sound"), res["study"]
