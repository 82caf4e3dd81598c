"""AlphaZero's network (Silver et al., Science 362:1140, 2018), which is
AlphaGo Zero's residual tower (Silver et al., Nature 550:354, 2017,
Methods, "Neural network architecture"): a 3×3 conv stem of ``channels``
filters, batch norm (BN), ReLU; ``blocks`` residual blocks of (3×3 conv →
BN → ReLU → 3×3 conv → BN, the block's input added, ReLU); a policy head
(1×1 conv to 2 filters, BN, ReLU, flattened cell by cell with the
channels innermost, a linear layer to the actions) and a value head (1×1
conv to 1 filter, BN, ReLU, a linear layer from the cells to
``channels``, ReLU, a linear layer to one, tanh).

Convolutions keep the board's size (padding k // 2), have weights ``(out,
in, kh, kw)`` and no bias, since a BN shift follows each; the linear
layers have biases.  A BN layer ``name`` has the parameters
``name.weight`` (ones) and ``name.bias`` (zeros) and the state
``name.running_mean`` and ``name.running_var``, as ``nn.BatchNorm2d``
names them.  :func:`forward` is BN's inference mode, from the state;
:func:`state` calibrates the state on a batch.

Assumed: BN's ε is 1e-5 (``nn.BatchNorm2d``'s); neither paper states it.
Departures from the papers: the input is the port's gomoku observation
(two planes, the mover's stones and the opponent's), not AlphaZero's
history planes and colour plane; the policy has no pass move; the value
head's hidden layer is ``channels`` wide, the papers' 256 at their
width.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from azbench.reference.games import Game
from azbench.reference.nets import family, linear_specs, ln_specs

BN_EPS = 1e-5

_resnet = family("resnet")
# the unfolded product, for cuDNN's float32 convolutions (resnet.py)
_conv = _resnet._conv
# BN, like LayerNorm there, is per-channel work the count leaves out
flops_per_pos = _resnet.flops_per_pos
_conv_specs = functools.partial(_resnet._conv_specs, bias=False)
# a BN's scale and shift are made as a LayerNorm's: ones and zeros
_bn_specs = ln_specs


def param_specs(model: dict, g: Game) -> list:
    c, RC = model["channels"], g.cells
    out = _conv_specs("stem", c, g.feature_dim, 3) + _bn_specs("stem_bn", c)
    for i in range(model["blocks"]):
        b = f"block_{i}"
        out += _conv_specs(f"{b}.conv1", c, c, 3) + _bn_specs(f"{b}.bn1", c)
        out += _conv_specs(f"{b}.conv2", c, c, 3) + _bn_specs(f"{b}.bn2", c)
    out += _conv_specs("policy_conv", 2, c, 1) + _bn_specs("policy_bn", 2)
    out += linear_specs("policy_head", g.action_dim, 2 * RC)
    out += _conv_specs("value_conv", 1, c, 1) + _bn_specs("value_bn", 1)
    out += linear_specs("value_fc", c, RC)
    out += linear_specs("value_head", 1, c)
    return out


def _bn(net, x, name, mean, var):
    """BN ``name`` of ``x (B, C, R, C')`` by the per-channel ``mean`` and
    ``var``."""
    return F.batch_norm(x, mean, var, net.p[f"{name}.weight"],
                        net.p[f"{name}.bias"], False, 0.0, BN_EPS)


def _net(net, obs, bn):
    """The network's outputs with ``bn(x, name)`` as its batch norm."""
    B = obs.shape[0]
    h = torch.relu(bn(_conv(net, obs, "stem"), "stem_bn"))
    for i in range(net.model["blocks"]):
        b = f"block_{i}"
        y = torch.relu(bn(_conv(net, h, f"{b}.conv1"), f"{b}.bn1"))
        h = torch.relu(h + bn(_conv(net, y, f"{b}.conv2"), f"{b}.bn2"))
    p = torch.relu(bn(_conv(net, h, "policy_conv"), "policy_bn"))
    logits = net._linear(p.permute(0, 2, 3, 1).reshape(B, -1), "policy_head")
    v = torch.relu(bn(_conv(net, h, "value_conv"), "value_bn")).reshape(B, -1)
    v = torch.relu(net._linear(v, "value_fc"))
    return logits, torch.tanh(net._linear(v, "value_head"))[:, 0]


def forward(net, obs):
    return _net(net, obs, lambda x, name: _bn(
        net, x, name, net.p[f"{name}.running_mean"],
        net.p[f"{name}.running_var"]))


def state(net, obs) -> dict:
    out = {}

    def bn(x, name):
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
        out[f"{name}.running_mean"], out[f"{name}.running_var"] = mean, var
        return _bn(net, x, name, mean, var)

    _net(net, obs, bn)
    return out
