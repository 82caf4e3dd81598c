"""Launches of the program's hand-written kernels (its ``CudaKernel``
counters, exact) in the window over its agent moves."""


def read(run):
    d = run.data
    if not d.get("moves") or d.get("launches") is None:
        return None
    return d["launches"] / d["moves"]
