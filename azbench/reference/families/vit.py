"""The ViT (the reference project's model): a stride-1 conv patch
embedding padded by ``patch // 2``, a CLS token and a learned position
embedding, pre-norm attention blocks (the query scaled by √Dh before the
product) with an exact-GELU 4× MLP, a final LayerNorm and float32 heads on
the CLS row."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from azbench.reference.games import Game
from azbench.reference.nets import linear_specs, ln_specs


def param_specs(model: dict, g: Game) -> list:
    E, k = model["embed_dim"], model["patch_size"]
    out = [("patch_embed.weight", (E, g.feature_dim, k, k), "lecun"),
           ("patch_embed.bias", (E,), "zeros"),
           ("cls_token", (1, 1, E), "normal"),
           ("pos_embed", (1, g.cells + 1, E), "normal")]
    for i in range(model["depth"]):
        b = f"block_{i}"
        out += ln_specs(f"{b}.norm1", E)
        for proj in ("query", "key", "value", "out"):
            out += linear_specs(f"{b}.attn.{proj}", E, E)
        out += ln_specs(f"{b}.norm2", E)
        out += linear_specs(f"{b}.mlp_fc1", 4 * E, E)
        out += linear_specs(f"{b}.mlp_fc2", E, 4 * E)
    out += ln_specs("norm", E)
    out += linear_specs("policy_head", g.action_dim, E)
    out += linear_specs("value_head", 1, E)
    return out


def forward(net, obs):
    m, g, B = net.model, net.g, obs.shape[0]
    E, H = m["embed_dim"], m["num_heads"]
    Dh = E // H
    k = m["patch_size"]
    q8, p = net.q, net.p
    h = F.conv2d(q8(obs), q8(p["patch_embed.weight"]), p["patch_embed.bias"],
                 padding=k // 2)
    h = h.permute(0, 2, 3, 1).reshape(B, g.cells, E)
    h = torch.cat([p["cls_token"].expand(B, 1, E), h], 1) + p["pos_embed"]
    T = h.shape[1]
    for i in range(m["depth"]):
        b = f"block_{i}"
        x = net._ln(h, f"{b}.norm1")
        q, kk, v = (net._linear(x, f"{b}.attn.{n}").reshape(B, T, H, Dh)
                    for n in ("query", "key", "value"))
        q = q / math.sqrt(Dh)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q8(q), q8(kk)), -1)
        a = torch.einsum("bhqk,bkhd->bqhd", q8(w), q8(v))
        h = h + net._linear(a.reshape(B, T, E), f"{b}.attn.out")
        y = F.gelu(net._linear(net._ln(h, f"{b}.norm2"), f"{b}.mlp_fc1"))
        h = h + net._linear(y, f"{b}.mlp_fc2")
    c = net._ln(h, "norm")[:, 0]
    value = torch.tanh(net._linear(c, "value_head"))[:, 0]
    return net._linear(c, "policy_head"), value


def flops_per_pos(model: dict, g: Game) -> float:
    """The products' multiply-adds × 2: the patch rows, then per block the
    four projections, the two attention products and the MLP over the
    ``cells + 1`` tokens (the heads not counted, as the root bench of the
    repo counts them)."""
    E, D = model["embed_dim"], model["depth"]
    RC = g.cells
    T = RC + 1
    f = model["patch_size"] ** 2 * g.feature_dim * E * RC \
        + D * (4 * E * E * T + 2 * T * T * E + 8 * E * E * T)
    return 2.0 * f
