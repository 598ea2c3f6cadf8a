"""The measured window: a loop's steps back to back, and what they record.

A loop (``loops/<name>.py``, named by the traffic mix's ``"loop"``) is
closed: its next step starts when the one before has its poses on the
host.  Each phase of a step runs inside a ``torch.profiler.record_function``
span of the harness (``bench.<phase>``), which a traced run reads to name
what the host was doing while the device sat idle; without a profiler the
spans cost nothing measurable.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

# request indices of set-up's warm-up calls: apart from the window's
WARMUP_BASE = 1 << 40


@dataclass
class Window:
    """What one window did, by the host clock."""

    start: float = 0.0
    end: float = 0.0
    pairs: int = 0              # pairs whose poses reached the host
    attempted: int = 0
    calls: int = 0
    outputs: Dict[int, dict] = field(default_factory=dict)  # kept requests

    @property
    def seconds(self) -> float:
        return self.end - self.start


def keep_outputs(res, u: Optional[int]) -> dict:
    """The outputs of one pair (``u``: its slot in a stacked result) on the
    host."""
    pick = (lambda t: t) if u is None else (lambda t: t[u])
    return {f: pick(getattr(res, f)).detach().cpu().clone()
            for f in ("pose", "num_mutual", "num_inliers", "kpts", "kpt_valid")}


def warm_up(loop, calls: int) -> None:
    """Set-up's calls: the first captures the program's graphs, the next
    replay them; their requests are apart from the window's."""
    w, r = Window(), WARMUP_BASE
    for _ in range(calls):
        r = loop.step(r, w)
    if loop.dev.type == "cuda":
        torch.cuda.synchronize(loop.dev)


def run(loop, seconds: Optional[float] = None, calls: Optional[int] = None,
        first: int = 0) -> Window:
    """Steps back to back from request ``first`` until ``seconds`` have
    passed (the last step started inside them is finished and counted) or
    ``calls`` steps are made."""
    w = Window()
    if loop.dev.type == "cuda":
        torch.cuda.synchronize(loop.dev)
    r = first
    w.start = time.perf_counter()
    while True:
        r = loop.step(r, w)
        now = time.perf_counter()
        if calls is not None and w.calls >= calls:
            break
        if seconds is not None and now - w.start >= seconds:
            break
    w.end = now
    return w
