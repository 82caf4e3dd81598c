"""The network forward's share of its roofline in the traced stretch: the
forward FLOPs of a position (``counts.model_flops_per_pos``) × the rows
the ``model.forward`` spans carry (their summed ``n``), over the device
time that is not the search's own (busy time less the ``az_sim_step`` and
``az_sim_flush`` kernels) × 989 TFLOP/s, in %.  It counts the same work
whatever implements the forward.  None without a trace, without the span
or where the spans carry no rows (a program whose span has no ``n``)."""

from azbench import counts, spans

SEARCH = ("sim_step_kernel", "sim_flush_kernel")


def read(run):
    p = run.profile
    hit = spans.totals().get("model.forward")
    if p is None or not hit or not hit[3]:
        return None
    search = sum(s for name, (_, s) in p.kernels.items()
                 if any(k in name for k in SEARCH))
    busy = p.busy_s - search
    if busy <= 0:
        return None
    flops = counts.model_flops_per_pos(run.model, run.game) * hit[3]
    return 100.0 * flops / (busy * counts.PEAK_BF16)
