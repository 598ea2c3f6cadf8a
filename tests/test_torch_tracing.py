"""The registration program's own accounting on the CPU
(``buffer_tpu_torch/pipeline/registration.py``, stored by
``buffer_tpu_torch/utils/profiling.py``): tracing follows the profiler,
the program's host spans exist only while it is on, the set-up counters,
the per-call records, and the stage marks of ``pair_front`` and
``pair_tail``.

A compiled program's call needs the card (CUDA graphs, streams, events),
so the call tests drive the program's real call path (``_Program``'s call
through ``_Chain.replay_front`` / ``replay_tail``) over stand-ins for the
graphs, streams and events; the card's side is in
``tests/test_torch_cuda.py``."""

import collections
import contextlib
import time
import weakref

import numpy as np
import pytest
import torch

from buffer_tpu_torch.config import tiny_cfg
from buffer_tpu_torch.core import graphs
from buffer_tpu_torch.data.preprocess import prepare_pair
from buffer_tpu_torch.data.synthetic import surface_pair
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.pipeline import registration as reg
from buffer_tpu_torch.utils import profiling

torch.set_num_threads(1)

FRONT_MS = {"pyramid": 1.0, "ref_keypt": 2.0, "fps": 0.5,
            "descriptors": 6.0, "match": 3.0}
TAIL_MS = {"ransac": 4.0, "refine": 5.0}


class Clock:
    """Stand-in timing events: each made (recorded) 1 ms after the one
    before; ``done`` decides what ``query()`` answers."""

    def __init__(self):
        self.t, self.done = 0.0, True

    def __call__(self, stream):
        self.t += 1.0
        return Event(self.t, self.done)


class Event:
    def __init__(self, t, done):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def elapsed_time(self, other):
        assert self.done and other.done
        return other.t - self.t


class Timer:
    """A stand-in :class:`StageTimer` whose replays took ``ms``."""

    def __init__(self, ms):
        self.ms, self.events = ms, []

    def ready(self):
        return all(e.done for e in self.events)

    def stage_ms(self, wait=True):
        return dict(self.ms)


class Stream:
    def wait_stream(self, other):
        pass


class Graph:
    """A stand-in graph: a replay records its timer's first mark."""

    def __init__(self, timer):
        self.timer, self.replays = timer, 0

    def replay(self):
        self.replays += 1
        self.timer.events = [reg._event(None)]


@pytest.fixture
def accounting(monkeypatch):
    """Fresh records and counters, stand-in events and CUDA streams."""
    monkeypatch.setattr(profiling, "_records",
                        collections.deque(maxlen=profiling.RECORDS))
    monkeypatch.setattr(profiling, "_counters",
                        dict.fromkeys(profiling._counters, 0))
    monkeypatch.setattr(profiling, "_sources", weakref.WeakSet())
    clock = Clock()
    monkeypatch.setattr(reg, "_event", clock)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(reg._Chain, "_capture", _capture)
    return clock


def _capture(self, *args):
    """A first call that takes 2 ms, its captures 1 ms of them."""
    time.sleep(0.002)
    self.capture_s = 0.001


def _chain(model, boost=False):
    """A ``_Chain`` with stand-in graphs: the real ``__init__`` with
    the capture left out, then what the capture would have made."""
    cpu = torch.device("cpu")
    mask = torch.ones(2, 4, dtype=torch.bool)
    inputs = reg.PairInputs(torch.zeros(2, 4, 3), mask, torch.zeros(2, 4, 3),
                            mask)
    draws = reg.Draws(torch.zeros(2, 4), torch.zeros(3), torch.zeros(1, 3, 2))
    c = reg._Chain(model, cpu, False, inputs, draws)
    c.cfg, c.return_intermediates = model.cfg, False
    c.guard = graphs.Guard(lambda: (*model.parameters(), *model.buffers()),
                           reg._STALE)
    c.stream = Stream()
    c.inputs, c.draws = graphs.clone(inputs), graphs.clone(draws)
    c.static = (*c.inputs, *c.draws)
    c.front_timer = Timer(FRONT_MS)
    c.tail_timers = {b: Timer(TAIL_MS) for b in (False, boost)}
    c.front_graph, c.front_launches, c.inter = Graph(c.front_timer), {}, {}
    c.front = reg.Front(*(torch.zeros(2) for _ in range(4)),
                        num_mutual=torch.tensor(40), kpts=torch.zeros(2, 2, 3),
                        kpt_valid=torch.ones(2, 2, dtype=torch.bool))
    c.tails = {b: (Graph(c.tail_timers[b]), (torch.eye(4), torch.tensor(7)),
                   {}) for b in (False, boost)}
    return c, inputs, draws


class _Model(torch.nn.Linear):
    def __init__(self):
        super().__init__(2, 2)
        self.cfg = tiny_cfg()


def _unrolled(chains):
    prog = object.__new__(reg._Program)
    prog.chains, prog.cfg, prog.dev = chains, chains[0].cfg, torch.device("cpu")
    prog.calls = reg._Calls()
    return prog


def test_tracing_follows_the_profiler():
    assert not profiling.tracing()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.tracing()
    assert not profiling.tracing()


def test_spans_only_while_tracing(accounting, monkeypatch):
    """The program's spans are opened only inside a profiler session, and
    there each one that the call path opens is in the profile; the first
    call and the host prep open none."""
    model = _Model()
    opened = []
    annotate = profiling.annotate
    monkeypatch.setattr(profiling, "annotate",
                        lambda name, args=None: opened.append(name)
                        or annotate(name, args))
    cfg = tiny_cfg()
    raw = np.random.RandomState(0).rand(600, 3).astype(np.float32)
    chains = [_chain(model)[0] for _ in range(2)]
    prog = _unrolled(chains)
    args = ([_chain(model)[1]] * 2, [_chain(model)[2]] * 2)
    prepare_pair(cfg, raw, raw + 0.01, already_downsampled=True, device="cpu")
    prog(*args)
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _chain(model)
        prepare_pair(cfg, raw, raw + 0.01, already_downsampled=True,
                     device="cpu")
        prog(*args)
    names = collections.Counter(e.name for e in prof.events())
    want = {"register.call": 1,
            "register.load": 2, "register.front": 2,
            "register.mutual_read": 1, "register.tail": 2,
            "register.outputs": 1}
    assert {k: names[k] for k in want} == want
    assert collections.Counter(opened) == want


def test_prepare_pair_adds_to_prep_s(accounting):
    cfg = tiny_cfg()
    raw = np.random.RandomState(1).rand(800, 3).astype(np.float32)
    assert profiling.counters()["prep.s"] == 0
    prepare_pair(cfg, raw, raw + 0.01, already_downsampled=True, device="cpu")
    first = profiling.counters()["prep.s"]
    assert first > 0
    prepare_pair(cfg, raw, raw + 0.01, already_downsampled=True, device="cpu")
    assert profiling.counters()["prep.s"] > first


def test_first_call_adds_to_capture_s(accounting):
    """The whole first call (warm-up and captures) adds to the counter;
    the program's ``capture_s`` keeps the captures alone."""
    model = _Model()
    chain = _chain(model)[0]
    assert chain.capture_s == 0.001
    assert profiling.counters()["register.capture_s"] >= 0.002


def test_call_records(accounting):
    """Each call's record is read during the next call (or by
    ``call_records``, which reads the pending call first); records are
    filtered by their entry time; a call gap runs from the same program's
    last call, another program's first call has none; a call whose events
    are not complete when read is left out and counted unread."""
    clock = accounting
    model = _Model()
    chains = [_chain(model)[0] for _ in range(3)]
    prog = _unrolled(chains)
    _, inputs, draws = _chain(model)
    args = ([inputs] * 3, [draws] * 3)
    t = []
    for _ in range(3):
        t.append(time.perf_counter())
        out = prog(*args)
    assert out.pose.shape == (3, 4, 4)
    assert len(profiling._records) == 2            # the third is pending
    recs = profiling.call_records(t[0], time.perf_counter())
    assert [r["index"] for r in recs] == [recs[0]["index"] + i for i in range(3)]
    assert all(t[i] <= r["t"] for i, r in enumerate(recs))
    assert all(r["t"] < t[i + 1] for i, r in enumerate(recs[:-1]))
    for r in recs:
        assert r["unroll"] == 3
        assert r["stages"] == [dict(FRONT_MS, **TAIL_MS)] * 3
        # events in order: call_start, 3 fronts' first marks, fronts_done,
        # 3 tails' first marks, call_end, each 1 ms after the last
        assert r["load_ms"] == 3.0 and r["tail_gap_ms"] == 1.0
    assert recs[0]["call_gap_ms"] is None
    assert [r["call_gap_ms"] for r in recs[1:]] == [1.0, 1.0]
    assert profiling.call_records(t[1], t[2]) == recs[1:2]
    assert profiling.call_records(time.perf_counter(), 1e12) == []

    other = _unrolled([_chain(model)[0] for _ in range(3)])
    other(*args)                       # another program between two calls
    prog(*args)
    more = profiling.call_records(t[2], 1e12)[1:]
    gaps = {r["index"]: r["call_gap_ms"] for r in more}
    # prog's call_end, other's nine events, prog's call_start
    assert [gaps[i] for i in sorted(gaps)] == [None, 10.0]

    clock.done = False                 # a call left running
    prog(*args)
    clock.done = True
    assert profiling.call_records(0, 1e12) == recs + more
    assert profiling.unread_calls(0, 1e12) == 1
    assert profiling.unread_calls(0, t[2]) == 0


def test_graph_program_call_reads_the_count_once(accounting):
    """``make_register_fn``'s program, one chain: the base tail without
    the low-match budget, the boost tail below its threshold."""
    model = _Model()
    chain, inputs, draws = _chain(model)
    prog = _unrolled([chain])
    res = prog([inputs], [draws])
    assert res.pose.shape == (1, 4, 4) and int(res.num_inliers[0]) == 7
    assert chain.tails[False][0].replays == 1 and chain.front_graph.replays == 1
    rec, = profiling.call_records(0, 1e12)
    assert rec["unroll"] == 1 and rec["stages"] == [dict(FRONT_MS, **TAIL_MS)]


def test_stage_marks_bound_the_stages(monkeypatch):
    """``StageTimer.STAGES`` names the stages in the order that
    ``pair_front`` and ``pair_tail`` mark them: the work between two marks
    of an eager ``register_pair`` is the named stage's."""
    log = []
    stage_of = {"build_pyramid_and_normals": "pyramid",
                "reference_axes": "ref_keypt", "detect_keypoints": "fps",
                "describe_both": "descriptors", "match_keypoints": "match",
                "cost_volume": "match", "vote": "match",
                "tail_ransac": "ransac", "tail_refine": "refine"}
    for fn_name in stage_of:
        fn = getattr(reg, fn_name)
        monkeypatch.setattr(reg, fn_name,
                            lambda *a, _f=fn, _n=fn_name, **k:
                            log.append(stage_of[_n]) or _f(*a, **k))

    class Marks:
        def mark(self):
            log.append("|")

    cfg = tiny_cfg()
    inputs, _ = surface_pair(cfg, 0, "cpu")
    model = BufferModel(cfg, seed=0).eval()
    draws = reg.make_draws(cfg, torch.Generator().manual_seed(0), "cpu")
    reg.register_pair(model, inputs, draws, device="cpu", timer=Marks())
    # six marks bound the front's five stages, three the tail's two
    segments = "".join(w if w == "|" else f"<{w}>" for w in log).split("|")
    assert segments[0] == "" and segments[6] == "" and segments[-1] == ""
    named = [s for i, s in enumerate(segments[1:-1]) if i != 5]
    assert [set(s[1:-1].split("><")) for s in named] == \
        [{s} for s in reg.StageTimer.STAGES]
    assert reg.StageTimer.FRONT + reg.StageTimer.TAIL == reg.StageTimer.STAGES


def test_analyze_trace_names_idle_gaps_by_program_spans(tmp_path, capsys):
    """``analyze_trace`` lists the card's idle gaps inside the ``replays``
    span, longest first, each named by the innermost ``register.*`` span
    at its midpoint."""
    import gzip
    import json

    from buffer_tpu_torch.scripts import analyze_trace

    def X(name, cat, ts, dur, corr=None):
        e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
             "pid": 0, "tid": 0}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [X("replays", "user_annotation", 0, 1000),
              X("register.call", "user_annotation", 0, 1000),
              X("register.front", "user_annotation", 5, 15),
              X("register.mutual_read", "user_annotation", 500, 200),
              X("register.tail", "user_annotation", 700, 20),
              X("cudaGraphLaunch", "cuda_runtime", 10, 5, corr=1),
              X("cudaGraphLaunch", "cuda_runtime", 705, 5, corr=2),
              X("k1", "kernel", 20, 380, corr=1),
              X("k2", "kernel", 410, 70, corr=1),
              X("k3", "kernel", 720, 180, corr=2),
              X("elsewhere", "kernel", 450, 200, corr=9)]
    path = tmp_path / "t.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    gaps = analyze_trace.analyze(str(path), iters=1)["idle_gaps"]
    assert [(g["span"], g["at_ms"], g["ms"]) for g in gaps] == [
        ("register.mutual_read", 0.48, 0.24), ("register.call", 0.9, 0.1),
        ("register.front", 0.0, 0.02), ("register.call", 0.4, 0.01)]
    assert analyze_trace.main([str(path), "--iters", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "in register.mutual_read" in out[-5]


def test_counters_under_threads(accounting):
    """Threads adding to one counter (host prep on producer threads) lose
    no update."""
    import sys
    import threading
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [profiling.count("prep.s", 1.0) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert profiling.counters()["prep.s"] == 16 * 2000
