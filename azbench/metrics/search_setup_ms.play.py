"""Host time an agent move's search spends before its simulations in the
traced stretch: the ``search.prepare`` and ``search.root`` spans summed,
over the ``search.move`` spans, in ms."""

from azbench import spans


def read(run):
    t = spans.totals()
    moves = t.get("search.move")
    if not moves or "search.root" not in t:
        return None
    setup = sum(t[k][1] for k in ("search.prepare", "search.root") if k in t)
    return setup / moves[0] * 1e3
