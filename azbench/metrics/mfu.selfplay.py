"""The model's share of the bf16 peak in the window: forward FLOPs of a
position (``counts.model_flops_per_pos``) × the network forwards of the
window's searches (env-steps × simulations) ÷ (seconds × 989 TFLOP/s), in
%."""

from azbench import counts


def read(run):
    d = run.data
    if not d.get("forwards"):
        return None
    flops = counts.model_flops_per_pos(run.model, run.game) * d["forwards"]
    return 100.0 * flops / (d["window_s"] * counts.PEAK_BF16)
