"""Median seconds of the window's self-play chunks (``collect`` records'
``chunk_seconds``, each ending in a device synchronisation), in ms."""

import statistics


def read(run):
    chunks = run.data.get("chunk_seconds")
    return statistics.median(chunks) * 1e3 if chunks else None
