"""The device's idle share of the traced stretch: 1 − the union of its
operations' intervals over the profiled span, both from the same trace,
in %."""


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
