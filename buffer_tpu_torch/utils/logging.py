"""Metric logging and timers (counterpart of ``buffer_tpu/utils/logging.py``).

The reference logs scalars to tensorboardX and prints meters every 200
iterations (ThreeDMatch/trainer.py:22,66-68,217-223); here metrics go to a
JSONL stream, optionally echoed to standard output.  :class:`Timer` and
:class:`AverageMeter` mirror the reference's ``utils/timer.py:4-55``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class Timer:
    """Host-clock timer: ``tic``/``toc`` pairs accumulate into ``avg``
    seconds a call.  The caller synchronizes the device before ``toc``
    where device work must be inside the interval."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.avg = 0.0

    def tic(self) -> None:
        self.start_time = time.time()

    def toc(self, average: bool = True) -> float:
        self.diff = time.time() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.avg = self.total_time / self.calls
        return self.avg if average else self.diff


class AverageMeter:
    """Running mean and variance of a scalar (weighted by ``n``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.sq_sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.sq_sum += val ** 2 * n
        self.var = self.sq_sum / self.count - self.avg ** 2


class MetricLogger:
    """Append-only JSONL metric stream (one object a call, with a ``ts``)."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, **kv) -> None:
        kv = {k: (float(v) if hasattr(v, "__float__") else v)
              for k, v in kv.items()}
        kv["ts"] = time.time()
        line = json.dumps(kv)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line, flush=True)
