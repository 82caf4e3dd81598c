"""A profiled stretch of a run: device busy time, kernel times by name and
the longest idle gaps, from one ``torch.profiler`` trace (CUPTI).

``profile(fn)`` runs ``fn`` inside a ``record_function`` span, ends in a
device synchronisation and returns a :class:`Trace`; the window is that
span, and busy time is the union of the device operations' intervals
inside it.  Each idle gap is labelled by the innermost host operation that
was running at its middle.
"""

from __future__ import annotations

import dataclasses

import torch

SPAN = "azbench.window"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict         # name → (launches, total seconds)
    gaps: list            # [(label, seconds)], longest first (at most 10)

    def kernel(self, fragment: str):
        """``(launches, mean seconds)`` of the kernels whose name holds
        ``fragment``, or None."""
        hits = [v for k, v in self.kernels.items() if fragment in k]
        n = sum(h[0] for h in hits)
        if not n:
            return None
        return n, sum(h[1] for h in hits) / n

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[k, v[1]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.gaps[:10]]}


def _merge(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(fn, device) -> Trace:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile, \
        record_function
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            fn()
            torch.cuda.synchronize(device)
    events = prof.events()
    span = [e for e in events if e.name == SPAN
            and e.device_type == DeviceType.CPU]
    if not span:
        raise RuntimeError("the profiler recorded no window span")
    ws, we = span[0].time_range.start, span[0].time_range.end
    kernels, iv = {}, []
    for e in events:
        # a host span is mirrored on the device's timeline as an
        # annotation: not an operation
        if (e.device_type != DeviceType.CUDA or e.name == SPAN
                or getattr(e, "is_user_annotation", False)):
            continue
        s, t = max(e.time_range.start, ws), min(e.time_range.end, we)
        if t <= s:
            continue
        n, tot = kernels.get(e.name, (0, 0.0))
        kernels[e.name] = (n + 1, tot + (t - s) / 1e6)
        iv.append((s, t))
    if not iv:
        raise RuntimeError("the profiler recorded no device operation")
    merged = _merge(iv)
    busy = sum(e - s for s, e in merged)
    holes, prev = [], ws
    for s, e in merged:
        if s > prev:
            holes.append((prev, s))
        prev = max(prev, e)
    if we > prev:
        holes.append((prev, we))
    holes.sort(key=lambda h: h[0] - h[1])
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name != SPAN]
    gaps = []
    for s, e in holes[:10]:
        mid = (s + e) / 2
        inside = [h for h in host
                  if h.time_range.start <= mid <= h.time_range.end]
        label = (max(inside, key=lambda h: h.time_range.start).name
                 if inside else "host outside any recorded operation")
        gaps.append((label, (e - s) / 1e6))
    return Trace(window_s=(we - ws) / 1e6, busy_s=busy / 1e6,
                 kernels=kernels, gaps=gaps)
