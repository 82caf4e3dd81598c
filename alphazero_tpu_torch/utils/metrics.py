"""Structured metrics: one JSON object per line.

Counterpart of the JAX package's ``utils/metrics.py``: each record is
``{"kind": ..., "t": seconds since the logger started, ...fields}``, printed
to stdout and appended to a file when a path is given.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stdout: bool = True):
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh: Optional[IO] = open(path, "a") if path else None
        self._stdout = stdout
        self._t0 = time.time()

    def log(self, kind: str, **fields):
        rec = {"kind": kind, "t": round(time.time() - self._t0, 3), **fields}
        line = json.dumps(rec, default=float)
        if self._stdout:
            print(line, flush=True)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
