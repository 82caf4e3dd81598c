"""Profiling hooks: a ``torch.profiler`` trace of a region and named spans.

Counterpart of the JAX package's ``utils/profiling.py`` (``jax.profiler``):
:func:`trace` records the host and, on a GPU, the device activity of the
enclosed region and writes a Chrome trace (open it in Perfetto or
``chrome://tracing``); :func:`annotate` names a span of that timeline.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed region into ``log_dir/trace-<time>.json``
    (nothing when ``log_dir`` is None)."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}.json"))


def annotate(name: str):
    """A named span in the trace timeline."""
    return record_function(name)
