"""Host time of one call of the eager evaluator (``models.make_eval_fn``)
in the traced stretch: the mean ``model.forward`` span, in µs."""

from azbench import spans


def read(run):
    hit = spans.totals().get("model.forward")
    if not hit:
        return None
    return hit[1] / hit[0] * 1e6
