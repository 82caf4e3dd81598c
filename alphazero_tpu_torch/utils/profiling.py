"""Profiling hooks: a ``torch.profiler`` trace of a region and the program's
spans.

Counterpart of the JAX package's ``utils/profiling.py`` (``jax.profiler``):
:func:`trace` records the host and, on a GPU, the device activity of the
enclosed region and writes a Chrome trace (open it in Perfetto or
``chrome://tracing``).

:func:`span` names a stretch of the program at a layer boundary (a play
move, a search and its parts, a self-play chunk, a trainer phase).  While
no profiler records, it returns one shared null context after a read of
the flag torch's profiler sets, and does nothing else.  While one records
(:func:`trace`, or any ``torch.profiler.profile``), the span enters a
``record_function`` of its name, so it lies on the profiler's timeline
beside the kernels it launched, and appends a :class:`Span` to this
process's record: its name, start and end (``time.perf_counter_ns``,
taken around the ``record_function``, so the span holds its event), its
parent span, its outermost span (the request: one agent move, one
self-play runner call) and a count ``n`` the caller knows on the host.
:func:`spans`, :func:`totals` and :func:`reset` read and clear the record.
The program is single-threaded on the host, so one stack of open spans a
process serves.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function


@dataclasses.dataclass
class Span:
    """One recorded span; ``parent`` and ``request`` index the record
    (``parent`` -1 for an outermost span, whose ``request`` is itself);
    ``end_ns`` is None while it is open."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    request: int
    n: int


_NULL = contextlib.nullcontext()
_record: list = []
_open: list = []


class _Recording:
    __slots__ = ("span", "index", "fn")

    def __init__(self, name: str, n: int):
        self.span = Span(name, 0, None, -1, -1, n)

    def __enter__(self):
        s = self.span
        self.index = len(_record)
        s.parent = _open[-1] if _open else -1
        s.request = _record[s.parent].request if _open else self.index
        _record.append(s)
        _open.append(self.index)
        self.fn = record_function(s.name)
        s.start_ns = time.perf_counter_ns()
        self.fn.__enter__()

    def __exit__(self, *exc):
        self.fn.__exit__(*exc)
        self.span.end_ns = time.perf_counter_ns()
        if _open and _open[-1] == self.index:
            _open.pop()
        return False


def span(name: str, n: int = 0):
    """A context manager around one stretch of the program named ``name``,
    carrying the host count ``n``; recorded only while a profiler
    records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Recording(name, n)


def spans() -> list:
    """The spans recorded since the last :func:`reset`, in start order."""
    return _record


def reset():
    """Forget every recorded span."""
    _record.clear()
    _open.clear()


def totals() -> dict:
    """``{name: (count, total_s, self_s, n)}`` over the closed spans: self
    time is the duration less what the span's children cover, ``n`` the
    sum of the spans' counts."""
    dur = [(s.end_ns - s.start_ns) if s.end_ns is not None else None
           for s in _record]
    child = [0] * len(_record)
    for s, d in zip(_record, dur):
        if d is not None and s.parent >= 0:
            child[s.parent] += d
    out = {}
    for s, d, c in zip(_record, dur, child):
        if d is None:
            continue
        k, tot, own, n = out.get(s.name, (0, 0.0, 0.0, 0))
        out[s.name] = (k + 1, tot + d / 1e9, own + (d - c) / 1e9, n + s.n)
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed region into ``log_dir/trace-<time>.json``
    (nothing when ``log_dir`` is None); the region's spans are on its
    timeline and, from its start, in :func:`spans`."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}.json"))
