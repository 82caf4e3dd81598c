"""Share of the eager evaluator's calls (``models.make_eval_fn``) in the
traced stretch that replayed a CUDA graph: ``model.graph`` spans ÷
``model.forward`` spans × 100, in %.  None where no call replayed one (a
program whose evaluator has no graphs)."""

from azbench import spans


def read(run):
    t = spans.totals()
    forward, graph = t.get("model.forward"), t.get("model.graph")
    if not forward or not graph:
        return None
    return graph[0] / forward[0] * 100
