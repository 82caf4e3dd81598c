"""Share of the move searches in the traced stretch whose simulations
replayed a CUDA graph (``search/fused.py``'s move search): ``search.graph``
spans ÷ ``search.sims`` spans × 100, in %.  None where no search replayed
one (a program whose move search has no graphs)."""

from azbench import spans


def read(run):
    t = spans.totals()
    sims, graph = t.get("search.sims"), t.get("search.graph")
    if not sims or not graph:
        return None
    return graph[0] / sims[0] * 100
