"""CUDA graphs: a fixed chain of launches captured once and replayed.

:func:`capture` records a chain; :class:`GraphCache` decides when a key's
chain is captured and how many keys are held.  The evaluator
(``models.Evaluator``) and the move search (``search.fused.MoveGraphs``)
are its two caches.  A replay runs the captured kernels, the eager ones.
"""

from __future__ import annotations

import torch

# A key's chain is captured at its CAPTURE_AT-th call (the calls before it
# run eagerly and warm its kernels up); a cache holds at most MAX_GRAPHS
# keys and runs every other key eagerly.
CAPTURE_AT = 3
MAX_GRAPHS = 4


def capture(fn, device) -> torch.cuda.CUDAGraph:
    """The graph of ``fn()``, which launches its work on the current
    stream: one warm-up call and the capture, both on a side stream of
    ``device`` as ``torch.cuda.graphs`` prescribes; the current stream then
    waits for the side stream."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        # thread_local: a profiler's own threads may call CUDA meanwhile
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            fn()
        torch.cuda.current_stream().wait_stream(side)
    return graph


class GraphCache:
    """Entries by key, each made at its key's ``CAPTURE_AT``-th call, at
    most ``MAX_GRAPHS`` of them.  ``captures`` and ``replays`` count the
    graphs made and the calls that replayed one (the caller counts a
    replay).  The CPU tests override the two hooks, :meth:`_engages` and
    :meth:`_capture`, so that a cache engages on the CPU and its "graph"
    reruns the chain."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self._calls = {}
        self._entries = {}

    def _engages(self, x) -> bool:
        """Whether a call on tensor ``x`` may replay a graph."""
        return x.is_cuda

    def _capture(self, fn, device):
        return capture(fn, device).replay

    def lookup(self, key, make):
        """The key's entry, or None where the call runs eagerly: before the
        key's ``CAPTURE_AT``-th call, or once ``MAX_GRAPHS`` other keys are
        held.  ``make()`` creates the entry at that call."""
        e = self._entries.get(key)
        if e is None:
            if len(self._entries) >= MAX_GRAPHS:
                return None
            n = self._calls[key] = self._calls.get(key, 0) + 1
            if n < CAPTURE_AT:
                return None
            e = self._entries[key] = make()
        return e

    def capture(self, fn, device):
        """Capture ``fn`` on ``device``; returns the replay."""
        self.captures += 1
        return self._capture(fn, device)
