"""Median latency of the window's agent moves, in ms."""

import statistics


def read(run):
    lat = run.data.get("latencies")
    return statistics.median(lat) * 1e3 if lat else None
