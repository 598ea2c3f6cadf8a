"""What the registration program records of itself, for the per-layer
metrics that read it: the per-call records of the calls that entered
inside the untraced window, and the process's set-up counters
(``buffer_tpu_torch.utils.profiling``'s ``call_records`` and
``counters``).  A program that keeps neither gives no records and no
counter, so its metrics read None; so do the window's records when one
of its calls went unread (``unread_calls``: its events were not complete
when the program read them), since their means would leave that call
out."""

from __future__ import annotations

from typing import Optional


def _profiling():
    from buffer_tpu_torch.utils import profiling
    return profiling


def window_records(run) -> list:
    """The records of the calls that entered inside ``run``'s window; none
    if a call of the window went unread."""
    profiling = _profiling()
    read = getattr(profiling, "call_records", None)
    if read is None:
        return []
    w = run["window"]
    recs = read(w.start, w.end)
    return [] if profiling.unread_calls(w.start, w.end) else recs


def mean(values: list) -> Optional[float]:
    return sum(values) / len(values) if values else None


def stage_ms(run, stage: str) -> Optional[float]:
    """Mean ms of ``stage`` a pair over the window's calls: one span a
    chain (a pair) a call, from the program's events on the chain's
    stream."""
    return mean([s[stage] for r in window_records(run) for s in r["stages"]
                 if stage in s])


def call_ms(run, key: str) -> Optional[float]:
    """Mean of a record's ``key`` (ms a call) over the window's calls that
    have it."""
    return mean([r[key] for r in window_records(run)
                 if r.get(key) is not None])


def counter(name: str) -> Optional[float]:
    """The process's counter ``name``, or None where the program keeps
    none or it never counted."""
    read = getattr(_profiling(), "counters", None)
    value = read().get(name) if read is not None else None
    return value if value else None
