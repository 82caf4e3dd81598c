"""Host time a simulation of the search's loop in the traced stretch: the
``search.sims`` spans' summed duration over the simulations they ran
(their ``n``), in µs.  One reader for every cell family
(``sim_loop_us.selfplay``, ``sim_loop_us.play``)."""

from azbench import spans


def read(run):
    hit = spans.totals().get("search.sims")
    if not hit or not hit[3]:
        return None
    return hit[1] / hit[3] * 1e6
