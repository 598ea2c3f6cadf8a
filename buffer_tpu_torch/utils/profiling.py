"""The helpers of the measurement entry points (``scripts/profile_*.py``,
``scripts/capture_*trace.py``), counterparts of
``buffer_tpu/utils/profiling.py`` and of the JAX scripts' on-device scan
timing: :func:`trace`, :func:`annotate`, :class:`StepTimer`,
:func:`graph_time` and :func:`replay_time`.

And the store of the compiled registration program's own accounting
(``pipeline/registration.py`` records it).  Always on: every replayed
call's record (:func:`call_records`: each chain's stage spans, the load,
the gap before the tails, the gap since the program's last call; the
calls whose events were not complete when read, :func:`unread_calls`),
and the set-up counters (:func:`counters`: ``register.capture_s``,
``prep.s``).  While a
``torch.profiler`` session is active (:func:`tracing`), the program's host
spans (:func:`span`): ``register.call`` (the call's index as its
argument), ``register.load``, ``register.front``, ``register.mutual_read``,
``register.tail`` and ``register.outputs``.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import math
import os
import shutil
import subprocess
import threading
import time
import weakref
from typing import Iterator, Optional

# torch.profiler keeps only the device records that it dates inside its
# capture window: on the card the first kernels of a call launched as the
# window opened went missing now and then (up to ~15 ms of them), so the
# profiled work starts, and the window closes, this long after the card
# is idle
SETTLE_S = 0.25
# ...and it lost the first device records of a window whole, the same
# ones in every profile of a process (a training step's input copies and
# first kernel, seen on the card): a window opens with this many spin
# kernels, which take that loss and which kernel_events leaves out
WARMUP_KERNELS = 4
SPIN_KERNEL = "spin_kernel"


def settle() -> None:
    """Waits for the card to finish, then :data:`SETTLE_S` seconds."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    time.sleep(SETTLE_S)


def open_window() -> None:
    """The start of a profiled window: :data:`WARMUP_KERNELS` spin kernels
    on the card (none without one), then :func:`settle`."""
    import torch
    if torch.cuda.is_available():
        for _ in range(WARMUP_KERNELS):
            torch.cuda._sleep(1000)
    settle()


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """A ``torch.profiler`` trace of the block's CPU activity and, where a
    card is present, its CUDA activity, written into ``log_dir`` as a
    gzipped Chrome trace ``<ns>.trace.json.gz``; yields that path.  Nothing
    (and None) when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{time.time_ns()}.trace.json")
    with profile(activities=activities) as prof:
        open_window()
        yield path + ".gz"
        settle()
    save_trace(prof, path)


@contextlib.contextmanager
def annotate(name: str, args: Optional[str] = None) -> Iterator[None]:
    """A named span: a ``torch.profiler`` record function (carrying
    ``args``) and, where a card is present, an NVTX range."""
    import torch
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name, args):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


# ---- the registration program's own accounting
#
# Always on: the per-call records that the compiled program
# (pipeline/registration.py) reads from its CUDA events, and the set-up
# counters.  Only while a torch.profiler session is active (tracing()):
# the program's host spans (span()), on the profiler's clock.

RECORDS = 4096                  # the per-call records kept, newest last

_lock = threading.Lock()
_records: collections.deque = collections.deque(maxlen=RECORDS)
_counters = {"register.capture_s": 0.0, "prep.s": 0.0}
_sources = weakref.WeakSet()    # what holds records back: flush()ed first


def tracing() -> bool:
    """Whether a ``torch.profiler`` session is active (``trace`` or any
    ``torch.profiler.profile``)."""
    import torch
    return torch.autograd._profiler_enabled()


def span(name: str, args: Optional[str] = None):
    """:func:`annotate` while :func:`tracing`, else a context that does
    nothing: one boolean check."""
    return annotate(name, args) if tracing() else contextlib.nullcontext()


def count(name: str, value: float) -> None:
    """Adds ``value`` to the counter ``name``."""
    with _lock:
        _counters[name] += value


def counters() -> dict:
    """``register.capture_s`` and ``prep.s``: host seconds, summed over the
    process."""
    with _lock:
        return dict(_counters)


def add_source(source) -> None:
    """``source.flush()`` adds the record it holds back (a call read only
    during the next one); :func:`call_records` calls it first."""
    _sources.add(source)


def add_record(record: dict) -> None:
    """Appends a call's record: ``t``, its host entry time, and either its
    numbers or ``unread`` (its events were not complete when read)."""
    with _lock:
        _records.append(record)


def _window(t_lo: float, t_hi: float) -> list:
    for source in list(_sources):
        source.flush()
    with _lock:
        return [r for r in _records if t_lo <= r["t"] <= t_hi]


def call_records(t_lo: float, t_hi: float) -> list:
    """The records of the calls that entered (host ``time.perf_counter``)
    within [t_lo, t_hi], held-back ones added first (call it between
    calls); unread calls are left out (:func:`unread_calls`).  A record:
    ``t`` (entry), ``index``, ``unroll`` (U), ``stages`` (a dict a chain:
    ms of each of ``StageTimer.STAGES`` on its stream), ``load_ms``
    (call_start to the start of the last chain's front graph: the loads
    and the fronts' launches), ``tail_gap_ms`` (fronts_done to the start
    of the first chain's tail graph: the mutual-count read and the tail's
    launch) and ``call_gap_ms`` (the program's previous call_end to this
    call_start; None for its first replay)."""
    return [r for r in _window(t_lo, t_hi) if not r.get("unread")]


def unread_calls(t_lo: float, t_hi: float) -> int:
    """How many calls that entered within [t_lo, t_hi] had events not yet
    complete when read, so have no record in :func:`call_records`."""
    return sum(1 for r in _window(t_lo, t_hi) if r.get("unread"))


class StepTimer:
    """Host-clock step timer that synchronizes the card (where one is
    present) before and after each measure, so that a step's time includes
    its device work; keeps every time and their median (seconds)."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self):
        import torch
        sync = (torch.cuda.synchronize if torch.cuda.is_available()
                else lambda: None)
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        self.times.append(time.perf_counter() - t0)

    @property
    def median(self) -> float:
        s = sorted(self.times)
        return s[len(s) // 2] if s else float("nan")


def replay_time(call, n_lo: int = 2, n_hi: int = 12, reps: int = 3) -> float:
    """Device milliseconds of one ``call()`` by differencing: ``n_lo``, then
    ``n_hi`` calls back to back between two CUDA events, ``reps`` times
    each; (min at n_hi - min at n_lo) / (n_hi - n_lo).  The fixed costs of
    a run (the first launch's latency, the events) cancel."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("replay_time: no CUDA device")

    def best(n: int) -> float:
        ms = math.inf
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                call()
            end.record()
            end.synchronize()
            ms = min(ms, start.elapsed_time(end))
        return ms

    torch.cuda.synchronize()
    lo = best(n_lo)
    return (best(n_hi) - lo) / (n_hi - n_lo)


def graph_time(body, n_lo: int = 2, n_hi: int = 12, reps: int = 3) -> float:
    """Device milliseconds of ``body`` (a closure over fixed input tensors
    that returns tensors), the counterpart of the JAX scripts' scan
    differencing: ``body`` runs once eagerly on a side stream (first-use
    allocations and caches), is captured once as a CUDA graph, and the
    graph's replays are timed by :func:`replay_time`.  Each replay adds the
    launches of the kernels it holds to their counters.  Raises without a
    card."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("graph_time: no CUDA device")
    from buffer_tpu_torch.core import graphs
    from buffer_tpu_torch.kernels import cuda
    graphs.warm(body, torch.device("cuda"))
    graph, out, launches = graphs.capture_graph(
        body, torch.cuda.graph_pool_handle())

    def replay():
        graph.replay()
        cuda.add_launches(launches)

    ms = replay_time(replay, n_lo, n_hi, reps)
    del out
    return ms


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_events(prof):
    """The device events of a profile, the window's spin kernels left
    out."""
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and SPIN_KERNEL not in e.name]


def save_trace(prof, path: str) -> None:
    prof.export_chrome_trace(path)
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)
