"""Depth-1 timeline attribution of a ``torch.profiler`` trace (counterpart
of the repository's ``scripts/analyze_trace.py``):

    python -m buffer_tpu_torch.scripts.analyze_trace [TRACE] [--iters 4]
        [--top 40] [--exact]

``TRACE`` is a Chrome trace (``.json`` or ``.json.gz``) or a directory, of
which the newest ``*.trace.json.gz`` is read (default: ``build/torchtrace/``
at the repository root, where ``capture_trace`` and ``capture_train_trace``
write).  The device events (kernels, memcpys, memsets) inside the widest
``replays`` span (``utils.profiling.annotate``; the JAX script takes the
outermost ``while``) are merged at depth 1 (an event starting before the
previous kept one ends is dropped: nested and overlapping events count
once) and aggregated by base name: the kernel name without its return
type, template arguments and parameter list (``--exact``: the full name).
Prints the depth-1 total, ms per iteration (``--iters``: the replays in the
span) and, largest first, each name's ms and count per iteration, then one
JSON line of the same.  Reads a file; needs no card.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
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


def span_events(events: list, span: str = "replays") -> list:
    """The device events lying wholly inside the widest CPU annotation
    named ``span``."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == span
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"no {span!r} annotation in the trace")
    w = max(spans, key=lambda e: e["dur"])
    lo, hi = w["ts"], w["ts"] + w["dur"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATS
            and lo <= e["ts"] and e["ts"] + e["dur"] <= hi]


def depth1(events: list) -> list:
    """The events kept at depth 1: by start (the longer first at equal
    starts), each that starts at or after the end of the last kept one."""
    events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    kept, end = [], -1
    for e in events:
        if e["ts"] >= end:
            kept.append(e)
            end = e["ts"] + e["dur"]
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
    """The attribution of one trace file as a dict (milliseconds)."""
    kept = depth1(span_events(load_events(path)))
    agg, cnt, sample = collections.Counter(), collections.Counter(), {}
    for e in kept:
        key = e["name"] if exact else base_name(e["name"])
        agg[key] += e["dur"]
        cnt[key] += 1
        sample.setdefault(key, e["name"])
    total = sum(e["dur"] for e in kept) / 1e3
    return {"trace": path, "events": len(kept), "total_ms": total,
            "iters": iters, "ms_per_iter": total / iters,
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
          f" -> {out['ms_per_iter']:.3f} ms/iter")
    for r in out["rows"]:
        print(f"{r['ms_per_iter']:8.3f} ms x{r['count_per_iter']:<7.2f} "
              f"{r['name'][:42]} | {r['sample']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
