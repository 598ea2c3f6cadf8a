"""Depth-1 timeline attribution of a ``torch.profiler`` trace (counterpart
of the repository's ``scripts/analyze_trace.py``):

    python -m buffer_tpu_torch.scripts.analyze_trace [TRACE] [--iters 4]
        [--top 40] [--exact]

``TRACE`` is a Chrome trace (``.json`` or ``.json.gz``) or a directory, of
which the newest ``*.trace.json.gz`` is read (default: ``build/torchtrace/``
at the repository root, where ``capture_trace`` and ``capture_train_trace``
write).  The device events (kernels, memcpys, memsets) of the work
launched inside the widest ``replays`` span (``utils.profiling.annotate``;
the JAX script takes the outermost ``while``) are merged at depth 1 (each
counts for its time that no earlier event covers: a nested event counts
nothing, one that starts before the previous one ends counts its time past
it) and aggregated by base name: the kernel name without its return type,
template arguments and parameter list (``--exact``: the full name).
Prints the depth-1 total, ms per iteration (``--iters``: the replays in the
span), the events counted in part and how late the last is dated,
largest first, each name's ms and count per iteration, then the device's
longest idle gaps inside the span (no event of the span's work running),
each named by the innermost span of the registration program
(``register.*``, opened while tracing) holding its midpoint, then one
JSON line of the same.  Reads a file; needs no card.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import math
import os
from typing import Optional, Sequence

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_path(path: str) -> str:
    """``path`` itself, or the newest ``*.trace.json.gz`` in the directory
    ``path``."""
    if not os.path.isdir(path):
        return path
    found = glob.glob(os.path.join(path, "*.trace.json.gz"))
    if not found:
        raise FileNotFoundError(f"no *.trace.json.gz under {path}")
    return max(found, key=os.path.getmtime)


def load_events(path: str) -> list:
    """The trace's ``traceEvents``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def widest_span(events: list, span: str = "replays") -> tuple:
    """(start, end) of the widest CPU annotation named ``span``."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == span
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"no {span!r} annotation in the trace")
    w = max(spans, key=lambda e: e["dur"])
    return w["ts"], w["ts"] + w["dur"]


def span_events(events: list, span: str = "replays") -> list:
    """The device events of the work launched inside the widest CPU
    annotation named ``span``: those whose correlation id is that of a CUDA
    runtime call lying wholly inside it.  (The trace dates device events
    on the host's clock by a conversion that now and then runs
    milliseconds late on the card, so a window of time would cut the
    span's last kernels.)"""
    lo, hi = widest_span(events, span)
    launched = {e["args"]["correlation"] for e in events
                if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})
                and lo <= e["ts"] and e["ts"] + e["dur"] <= hi}
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATS
            and e.get("args", {}).get("correlation") in launched]


def idle_gaps(events: list, top: int = 10, span: str = "replays",
              prefix: str = "register.") -> list:
    """The ``top`` longest gaps inside the widest ``span`` in which none of
    its device events (:func:`span_events`) runs, longest first: each as
    ``{"span", "at_ms", "ms"}``, ``span`` the innermost CPU annotation
    whose name starts with ``prefix`` holding the gap's midpoint (else
    ``host``), ``at_ms`` its start after the span's."""
    lo, hi = widest_span(events, span)
    named = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(prefix)]
    gaps, t = [], lo
    for e in sorted(span_events(events, span), key=lambda e: e["ts"]):
        if e["ts"] > t:
            gaps.append((t, min(e["ts"], hi)))
        t = max(t, e["ts"] + e["dur"])
    if t < hi:
        gaps.append((t, hi))

    def name_at(x):
        inside = [(b - a, n) for a, b, n in named if a <= x <= b]
        return min(inside)[1] if inside else "host"

    gaps = sorted(((a, b) for a, b in gaps if b > a), key=lambda g: g[0] - g[1])
    return [{"span": name_at(0.5 * (a + b)), "at_ms": (a - lo) / 1e3,
             "ms": (b - a) / 1e3} for a, b in gaps[:top]]


def depth1(events: list) -> list:
    """(event, microseconds) of the events that count at depth 1: by start
    (the longer first at equal starts), an event starting at or after the
    end of all before it counts in full (the events that the JAX script's
    ``depth1`` keeps), one that ends past that end counts for its time
    past it, and one wholly covered not at all.  On one CUDA stream the
    trace now and then dates a kernel's start a fraction of a microsecond
    before the previous one's end: dropping such a kernel whole, as the
    JAX script's merge of nested XLA ops does, lost 14% of a replay's
    time in one run on the card."""
    events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    kept, end = [], -math.inf
    for e in events:
        stop = e["ts"] + e["dur"]
        if e["ts"] >= end:
            kept.append((e, e["dur"]))
        elif stop > end:
            kept.append((e, stop - end))
        end = max(end, stop)
    return kept


def base_name(name: str) -> str:
    """A kernel's name without its parameter list, template arguments and
    ``void`` return type: ``void ns::k<4, T>(int, float*)`` -> ``ns::k``."""
    n = name.strip()
    if n.endswith(")"):
        depth = 0
        for i in range(len(n) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i]
                break
    kept, depth = [], 0
    for c in n:
        if c == "<":
            depth += 1
        elif c == ">" and depth:
            depth -= 1
        elif not depth:
            kept.append(c)
    n = "".join(kept).strip()
    return n[len("void "):] if n.startswith("void ") else n


def analyze(path: str, iters: int = 4, top: int = 40,
            exact: bool = False) -> dict:
    """The attribution of one trace file as a dict (milliseconds).  Also:
    ``in_part``, the events counted only in part (the JAX script's merge
    drops each whole), and ``in_part_ms_per_iter``, their whole time an
    iteration; ``late_ms``, how far past the span's end the last device
    event is dated."""
    events = load_events(path)
    device = span_events(events)
    kept = depth1(device)
    in_part = [e for e, us in kept if us < e["dur"]]
    late = max([e["ts"] + e["dur"] for e in device], default=-math.inf) \
        - widest_span(events)[1]
    agg, cnt, sample = collections.Counter(), collections.Counter(), {}
    for e, us in kept:
        key = e["name"] if exact else base_name(e["name"])
        agg[key] += us
        cnt[key] += 1
        sample.setdefault(key, e["name"])
    total = sum(us for _, us in kept) / 1e3
    return {"trace": path, "events": len(kept), "total_ms": total,
            "iters": iters, "ms_per_iter": total / iters,
            "in_part": len(in_part), "in_part_ms_per_iter":
                sum(e["dur"] for e in in_part) / iters / 1e3,
            "late_ms": max(late, 0) / 1e3,
            "idle_gaps": idle_gaps(events),
            "rows": [{"name": k, "ms_per_iter": d / iters / 1e3,
                      "count_per_iter": cnt[k] / iters,
                      "sample": sample[k][:110]}
                     for k, d in agg.most_common(top)]}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m buffer_tpu_torch.scripts.analyze_trace")
    ap.add_argument("trace", nargs="?", default=None,
                    help="trace file or directory (default: build/torchtrace/)")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--exact", action="store_true",
                    help="aggregate by the exact kernel name, not its base")
    args = ap.parse_args(argv)
    if args.trace is None:
        from buffer_tpu_torch.kernels.cuda import BUILD_DIR
        args.trace = str(BUILD_DIR / "torchtrace")
    out = analyze(trace_path(args.trace), args.iters, args.top, args.exact)
    print(f"depth-1: {out['events']} events, {out['total_ms']:.3f} ms total"
          f" -> {out['ms_per_iter']:.3f} ms/iter; {out['in_part']} counted"
          f" in part ({out['in_part_ms_per_iter']:.3f} ms/iter whole), the"
          f" last dated {out['late_ms']:.3f} ms past the span")
    for r in out["rows"]:
        print(f"{r['ms_per_iter']:8.3f} ms x{r['count_per_iter']:<7.2f} "
              f"{r['name'][:42]} | {r['sample']}")
    for g in out["idle_gaps"]:
        print(f"idle {g['ms']:8.3f} ms at {g['at_ms']:.3f} ms in {g['span']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
