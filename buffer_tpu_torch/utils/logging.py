"""Metric logging (counterpart of ``buffer_tpu/utils/logging.py``).

The reference logs scalars to tensorboardX and prints meters every 200
iterations (ThreeDMatch/trainer.py:22,66-68,217-223); here metrics go to a
JSONL stream, optionally echoed to standard output.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


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
