"""The readers of the registration program's own records and counters on
made-up records: the window's calls only, None without any."""

import collections
import weakref

import pytest

from benchmark.harness import manifest as mf
from benchmark.harness.window import Window
from buffer_tpu_torch.utils import profiling

STAGES = ("pyramid", "ref_keypt", "fps", "descriptors", "match", "ransac",
          "refine")
CALLS = ("load_ms", "tail_gap_ms", "call_gap_ms")


def _record(t, scale, unroll=3, gap=True):
    return {"t": t, "index": int(t), "unroll": unroll,
            "stages": [{s: scale * (i + 1) + u for i, s in enumerate(STAGES)}
                       for u in range(unroll)],
            "load_ms": 0.5 * scale, "tail_gap_ms": 0.25 * scale,
            "call_gap_ms": 2.0 * scale if gap else None}


@pytest.fixture
def recorded(monkeypatch):
    """Records at host times 1, 2, 3 (inside the window [1.5, 3.5]: the
    calls at 2 and 3) and 9, and counters; none pending."""
    recs = collections.deque([_record(1.0, 100.0), _record(2.0, 1.0, gap=False),
                              _record(3.0, 3.0), _record(9.0, 100.0)])
    monkeypatch.setattr(profiling, "_records", recs)
    monkeypatch.setattr(profiling, "_sources", weakref.WeakSet())
    monkeypatch.setattr(profiling, "_counters", {
        "register.capture_s": 4.5, "prep.s": 0.75})
    return {"window": Window(start=1.5, end=3.5)}


def _read(name, run):
    return mf.load_reader(name)(run)


@pytest.mark.parametrize("i,stage", list(enumerate(STAGES)))
def test_stage_readers(recorded, i, stage):
    # the mean over the 6 pairs of the calls at 2 and 3
    want = sum(scale * (i + 1) + u for scale in (1.0, 3.0) for u in range(3)) / 6
    assert _read(f"{stage}_ms.testset", recorded) == pytest.approx(want)


@pytest.mark.parametrize("key,want", [("load_ms", 1.0), ("tail_gap_ms", 0.5),
                                      ("call_gap_ms", 6.0)])
def test_call_readers(recorded, key, want):
    # call_gap_ms: the call at 2 has none (the first after a capture)
    assert _read(f"{key}.testset", recorded) == pytest.approx(want)


def test_counter_readers(recorded):
    assert _read("capture_s.testset", recorded) == 4.5
    assert _read("prep_s.testset", recorded) == 0.75


@pytest.mark.parametrize("name", [f"{s}_ms.testset" for s in STAGES]
                         + [f"{k}.testset" for k in CALLS])
def test_none_without_records_in_the_window(recorded, name):
    assert _read(name, {"window": Window(start=4.0, end=8.0)}) is None


@pytest.mark.parametrize("name", ["capture_s.testset", "prep_s.testset"])
def test_counters_none_without_counts(monkeypatch, name):
    monkeypatch.setattr(profiling, "_counters", {
        "register.capture_s": 0.0, "prep.s": 0.0})
    assert _read(name, {}) is None


@pytest.mark.parametrize("name", [f"{s}_ms.testset" for s in STAGES]
                         + [f"{k}.testset" for k in CALLS])
def test_none_with_an_unread_call_in_the_window(recorded, name):
    """A call of the window whose events were not complete when read has
    no record: the window's means would leave it out, so they read None;
    an unread call outside the window changes nothing."""
    profiling._records.append({"t": 8.0, "index": 8, "unread": True})
    assert _read(name, recorded) is not None
    profiling._records.append({"t": 2.5, "index": 2, "unread": True})
    assert _read(name, recorded) is None


@pytest.mark.parametrize("name", [f"{s}_ms.testset" for s in STAGES]
                         + [f"{k}.testset" for k in CALLS]
                         + ["capture_s.testset", "prep_s.testset"])
def test_a_program_without_records_reads_none(monkeypatch, name):
    """An older program keeps no records and no counters: the readers
    give None and do not raise."""
    monkeypatch.delattr(profiling, "call_records")
    monkeypatch.delattr(profiling, "counters")
    assert _read(name, {"window": Window(start=0.0, end=1e12)}) is None
