"""The yardstick: peaks of one H100 and the work of a forward or a kernel,
from shapes alone.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit (dense
rates): 989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores,
3.35 TB/s of HBM.  A bound counts each input byte read once and each
output byte written once, and the operations the computation needs,
whatever a kernel reads again or pads.
"""

from __future__ import annotations

from azbench.reference import nets
from azbench.reference.games import Game, line_cells

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_HBM = 3.35e12


def bound_s(nbytes: float, bf16_ops: float = 0.0, f32_ops: float = 0.0):
    """``(seconds, "bytes" | "operations")``: the least time of the work."""
    t_bytes = nbytes / PEAK_HBM
    t_ops = bf16_ops / PEAK_BF16 + f32_ops / PEAK_F32
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def model_flops_per_pos(model: dict, g: Game) -> float:
    """Forward FLOPs of one position: ``flops_per_pos`` of the model's
    family file (``azbench/reference/families/<family>.py``); raises
    ValueError for a family that has no file."""
    return nets.family(model["family"]).flops_per_pos(model, g)


def dense_forward_bound(model: dict, g: Game, B: int):
    """``az_dense_forward`` at batch B: the stem, the blocks and
    ``value_fc`` as bf16 products, the policy and value heads in float32;
    bytes: those weights (bf16 matrices, float32 biases, LayerNorms and
    heads), the float32 observations in and probabilities and values
    out."""
    D, nb, A = model["width"], model["blocks"], g.action_dim
    DV = D // 4
    kin = g.feature_dim * g.cells + 2 * len(
        line_cells(g.rows, g.cols, g.win_len))
    bf16_ops = 2.0 * B * (kin * D + nb * 2 * D * D + D * DV)
    f32_ops = 2.0 * B * (D * A + DV)
    weights = 2 * (kin * D + nb * 2 * D * D + D * DV) \
        + 4 * (D + nb * 4 * D + 2 * D + A * D + A + DV + DV + 1)
    io = 4 * B * g.feature_dim * g.cells + 4 * B * (A + 1)
    return bound_s(weights + io, bf16_ops, f32_ops)


def sim_step_bound(g: Game, B: int, sims: int):
    """``az_sim_step`` at batch B: the flush of the previous simulation
    and the next one's walk, for a walk of one ply per game (the least any
    step does): the leaf record, legal mask, probabilities and value read,
    the new prior row written, two plies backed up (24 bytes of stats read
    and written, a path entry each), the root boards read, one edge row
    (prior and child, 8 bytes an action) and every root child's stats (12
    bytes) read, the walk's path, action path and record and the leaf's
    legal mask and float32 observation written."""
    A, RC, F = g.action_dim, g.cells, g.feature_dim
    dcap = min(g.max_moves + 1, sims + 1)
    plies = 2 * B
    flush = B * A * 4 + B * 4 + B * 32 + B * A + plies * 28 + B * A * 4 \
        + B * 4
    step = flush + B * 2 * RC + B * 8 + B * A * 8 + B * A * 12 \
        + 2 * B * dcap * 4 + B * 32 + B * A + B * F * RC * 4
    return bound_s(step, f32_ops=B * A * 8.0 + 2.0 * plies)
