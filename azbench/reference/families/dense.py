"""The dense tower (the flax ``DenseTower`` the configurations name): the
input planes and the per-plane win-line sums over ``win_len`` go through a
stem, pre-LayerNorm residual MLP blocks (LN → fc1 → ReLU → fc2), a final
LayerNorm, a policy head and a value head (``value_fc`` → ReLU →
``value_head`` → tanh)."""

from __future__ import annotations

import torch

from azbench.reference.games import Game, line_cells
from azbench.reference.nets import linear_specs, ln_specs


def _kin(g: Game) -> int:
    """The stem's inputs: the planes and two line sums per line."""
    return g.feature_dim * g.cells + 2 * len(
        line_cells(g.rows, g.cols, g.win_len))


def param_specs(model: dict, g: Game) -> list:
    D = model["width"]
    out = linear_specs("stem", D, _kin(g))
    for i in range(model["blocks"]):
        out += ln_specs(f"block_{i}.ln", D)
        out += linear_specs(f"block_{i}.fc1", D, D)
        out += linear_specs(f"block_{i}.fc2", D, D)
    out += ln_specs("final_ln", D)
    out += linear_specs("policy_head", g.action_dim, D)
    out += linear_specs("value_fc", D // 4, D)
    out += linear_specs("value_head", 1, D // 4)
    return out


def forward(net, obs):
    g, B = net.g, obs.shape[0]
    lines = g.lines(obs.device)
    flat = obs.reshape(B, -1)
    RC = g.cells
    lf = torch.cat([flat[:, :RC][:, lines].sum(-1),
                    flat[:, RC:2 * RC][:, lines].sum(-1)], -1)
    h = net._linear(torch.cat([flat, lf / g.win_len], -1), "stem")
    for i in range(net.model["blocks"]):
        y = net._ln(h, f"block_{i}.ln")
        y = torch.relu(net._linear(y, f"block_{i}.fc1"))
        h = h + net._linear(y, f"block_{i}.fc2")
    h = net._ln(h, "final_ln")
    v = torch.relu(net._linear(h, "value_fc"))
    value = torch.tanh(net._linear(v, "value_head"))[:, 0]
    return net._linear(h, "policy_head"), value


def flops_per_pos(model: dict, g: Game) -> float:
    """The products' multiply-adds × 2, the heads as the root bench of the
    repo counts them."""
    w = model["width"]
    f = _kin(g) * w + 2 * model["blocks"] * w * w \
        + w * (g.action_dim + w // 4)
    return 2.0 * f
