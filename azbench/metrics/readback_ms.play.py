"""Host time an agent move waits for its visit counts to reach the host
(the card's queue draining) in the traced stretch: the mean
``play.readback`` span, in ms."""

from azbench import spans


def read(run):
    hit = spans.totals().get("play.readback")
    if not hit:
        return None
    return hit[1] / hit[0] * 1e3
