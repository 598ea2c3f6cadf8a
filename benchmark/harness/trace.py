"""The traced segment of a ``--trace 1`` run and what is read from it.

After the window, the loop makes one more call under ``torch.profiler``
(the profiler loses the first device records of a window, so that call is
left out), then ``calls`` calls whose span is the traced window.  From the
profile come: the device intervals (every device event: kernels, copies,
sets), their union (``busy_s``), the time of each kernel class of
``kernel_classes.json`` (a kernel that no class claims is ``other``), the
device operations that took most time, and the longest idle gaps of the
device named by the harness span the host was in at the time.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from benchmark.harness import window as win

SPAN_PREFIX = "bench."


@dataclass
class Trace:
    window_s: float
    busy_s: float
    calls: int
    pairs: int
    kernels: List[Tuple[str, float, float]]          # (name, start, end) s
    class_s: Dict[str, float] = field(default_factory=dict)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


def classify(name: str, classes: dict) -> str:
    """The first class of ``kernel_classes.json`` whose pattern matches
    ``name`` (a regular expression, searched), else ``other``."""
    for c in classes["classes"]:
        if any(re.search(p, name) for p in c["patterns"]):
            return c["name"]
    return "other"


def union_s(intervals: List[Tuple[float, float]]) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """The idle gaps of ``intervals`` inside [lo, hi]: (start, end)."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def span_at(spans: List[Tuple[str, float, float]], t: float) -> str:
    """The innermost harness span holding host time ``t``, else ``host``."""
    best = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else "host"


def read_profile(events, t_lo: float, t_hi: float, classes: dict,
                 calls: int, pairs: int, top: int = 10) -> Trace:
    """A :class:`Trace` of the device events (``(name, start s, end s,
    on_device)``) that start inside [t_lo, t_hi], the traced window."""
    dev = [(n, s, e) for n, s, e, on in events
           if on and t_lo <= s <= t_hi]
    spans = [(n, s, e) for n, s, e, on in events
             if not on and n.startswith(SPAN_PREFIX)]
    iv = [(s, e) for _, s, e in dev]
    tr = Trace(window_s=t_hi - t_lo, busy_s=union_s(iv), calls=calls,
               pairs=pairs, kernels=dev)
    by_name: Dict[str, float] = {}
    for n, s, e in dev:
        c = classify(n, classes)
        tr.class_s[c] = tr.class_s.get(c, 0.0) + (e - s)
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    tr.device_ops = [[f"{classify(n, classes)}: {n[:96]}", v] for n, v in
                     sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
    by_span: Dict[str, float] = {}
    longest = sorted(gaps(iv, t_lo, t_hi), key=lambda g: g[0] - g[1])
    for a, b in longest[:top]:
        by_span.setdefault(f"{span_at(spans, 0.5 * (a + b))} "
                           f"@{a - t_lo:.6f}s", b - a)
    tr.idle_gaps = [[k, v] for k, v in by_span.items()]
    return tr


def profile_events(prof) -> list:
    """(name, start s, end s, on_device) of every event of a profile; the
    device's and the host's share one clock."""
    out = []
    for e in prof.events():
        on = e.device_type == torch.autograd.DeviceType.CUDA
        if on and getattr(e, "is_user_annotation", False):
            continue
        out.append((e.name, e.time_range.start * 1e-6,
                    e.time_range.end * 1e-6, on))
    return out


def traced_segment(loop, classes: dict, calls: int, first: int) -> Trace:
    """One call left out, then ``calls`` calls traced from request
    ``first``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        r = loop.step(first, win.Window())
        torch.cuda.synchronize(loop.dev)
        with torch.profiler.record_function("bench.traced_window"):
            w = win.run(loop, calls=calls, first=r)
        torch.cuda.synchronize(loop.dev)
    events = profile_events(prof)
    spans = [(s, e) for n, s, e, on in events if n == "bench.traced_window"]
    if not spans:
        raise RuntimeError("the profile holds no traced window span")
    t_lo, t_hi = spans[0]
    return read_profile(events, t_lo, t_hi, classes, w.calls, w.pairs)
