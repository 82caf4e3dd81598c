"""The conv ResNet (the flax ``ResNet`` of the port's ``resnet`` family):
a bias-free 3×3 conv stem, a LayerNorm of each cell over the channels and
a ReLU; blocks of (3×3 conv → LayerNorm → ReLU → 3×3 conv → LayerNorm,
the residual added, ReLU); a policy head (1×1 conv to 2 channels with a
bias, ReLU, flattened cell by cell with the channels innermost, a linear
layer to the actions) and a value head (1×1 conv to 1 channel with a
bias, ReLU, a linear layer from the cells to ``channels``, ReLU, a linear
layer to one, tanh).  Convolutions keep the board's size (padding k // 2);
their weights are ``(out, in, kh, kw)``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from azbench.reference.games import Game
from azbench.reference.nets import linear_specs, ln_specs


def _conv_specs(name: str, o: int, i: int, k: int, bias: bool) -> list:
    out = [(f"{name}.weight", (o, i, k, k), "lecun")]
    return out + [(f"{name}.bias", (o,), "zeros")] if bias else out


def param_specs(model: dict, g: Game) -> list:
    c, RC = model["channels"], g.cells
    out = _conv_specs("stem", c, g.feature_dim, 3, False)
    out += ln_specs("stem_ln", c)
    for i in range(model["blocks"]):
        b = f"block_{i}"
        out += _conv_specs(f"{b}.conv1", c, c, 3, False)
        out += ln_specs(f"{b}.ln1", c)
        out += _conv_specs(f"{b}.conv2", c, c, 3, False)
        out += ln_specs(f"{b}.ln2", c)
    out += _conv_specs("policy_conv", 2, c, 1, True)
    out += linear_specs("policy_head", g.action_dim, 2 * RC)
    out += _conv_specs("value_conv", 1, c, 1, True)
    out += linear_specs("value_fc", c, RC)
    out += linear_specs("value_head", 1, c)
    return out


def _conv(net, x, name):
    """``x (B, C, R, C')`` convolved by ``name``, both operands rounded by
    the net's precision, as a product of the weights and the unfolded
    input.  On an H100 (cuDNN 9.2, PyTorch 2.11, TF32 off) a forward by
    cuDNN's float32 convolutions reads wrong from 128 rows on (outputs off
    by up to 0.78 at 192×10 on gomoku15, B=256), where this one agrees with
    the CPU's to 7e-6."""
    w = net.q(net.p[f"{name}.weight"])
    o, _, k, _ = w.shape
    B, _, R, C = x.shape
    cols = F.unfold(net.q(x), k, padding=k // 2)         # (B, C·k·k, R·C')
    y = torch.matmul(w.reshape(o, -1), cols).reshape(B, o, R, C)
    b = net.p.get(f"{name}.bias")
    return y if b is None else y + b[:, None, None]


def _cell_ln(net, x, name):
    """LayerNorm of each cell of ``x (B, C, R, C')`` over its channels."""
    return net._ln(x.permute(0, 2, 3, 1), name).permute(0, 3, 1, 2)


def forward(net, obs):
    B = obs.shape[0]
    h = torch.relu(_cell_ln(net, _conv(net, obs, "stem"), "stem_ln"))
    for i in range(net.model["blocks"]):
        b = f"block_{i}"
        y = torch.relu(_cell_ln(net, _conv(net, h, f"{b}.conv1"), f"{b}.ln1"))
        y = _cell_ln(net, _conv(net, y, f"{b}.conv2"), f"{b}.ln2")
        h = torch.relu(h + y)
    p = torch.relu(_conv(net, h, "policy_conv"))
    logits = net._linear(p.permute(0, 2, 3, 1).reshape(B, -1), "policy_head")
    v = torch.relu(_conv(net, h, "value_conv")).reshape(B, -1)
    v = torch.relu(net._linear(v, "value_fc"))
    value = torch.tanh(net._linear(v, "value_head"))[:, 0]
    return logits, value


def flops_per_pos(model: dict, g: Game) -> float:
    """The convolutions' multiply-adds × 2: the stem, two 3×3 convs a
    block, the heads' 1×1 convs, and 32 a cell for the heads' linear
    layers (as the root bench of the repo counts them)."""
    RC = g.cells
    c, nb = model["channels"], model["blocks"]
    f = 9 * g.feature_dim * c * RC + nb * 2 * 9 * c * c * RC \
        + 2 * c * RC + 32 * RC
    return 2.0 * f
