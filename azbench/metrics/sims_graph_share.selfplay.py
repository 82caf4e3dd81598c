"""Share of the self-play chunk's moves in the traced stretch whose
simulations replayed a CUDA graph (``search/fused.py``'s chunk on the move
search's graphs): ``search.graph`` spans ÷ ``search.sims`` spans × 100, in
%.  None where no move replayed one (a program whose chunk has no
graphs)."""

from azbench import spans


def read(run):
    t = spans.totals()
    sims, graph = t.get("search.sims"), t.get("search.graph")
    if not sims or not graph:
        return None
    return graph[0] / sims[0] * 100
