"""Plain forwards of the benchmark's networks, in float32 with TF32 off.

* The dense tower (the flax ``DenseTower`` the configurations name): the
  input planes and the per-plane win-line sums over ``win_len`` go through a
  stem, pre-LayerNorm residual MLP blocks (LN → fc1 → ReLU → fc2), a final
  LayerNorm, a policy head and a value head (``value_fc`` → ReLU →
  ``value_head`` → tanh).
* The ViT (the reference project's model): a stride-1 conv patch embedding
  padded by ``patch // 2``, a CLS token and a learned position embedding,
  pre-norm attention blocks (the query scaled by √Dh before the product)
  with an exact-GELU 4× MLP, a final LayerNorm and float32 heads on the
  CLS row.

LayerNorm eps is 1e-6 (flax).  Parameters are a dict of float32 tensors
under the flax tree's names (``param_specs`` lists them with their shapes
and their initialisation).  ``precision="fp8"`` rounds both operands of
every matrix product and of the patch convolution to float8 e4m3 with a
per-tensor scale, the control of the benchmark's correctness check.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from azbench.reference.games import Game, line_cells

LN_EPS = 1e-6
FP8_MAX = 448.0          # largest finite float8 e4m3fn


def param_specs(model: dict, g: Game) -> list:
    """``[(name, shape, init)]`` of a configuration's ``model`` section;
    ``init`` is ``lecun`` (normal over √fan-in, cut at 2σ), ``normal``,
    ``zeros`` or ``ones``."""
    A = g.action_dim
    out = []

    def linear(name, o, i):
        out.extend([(f"{name}.weight", (o, i), "lecun"),
                    (f"{name}.bias", (o,), "zeros")])

    def ln(name, d):
        out.extend([(f"{name}.weight", (d,), "ones"),
                    (f"{name}.bias", (d,), "zeros")])

    if model["family"] == "dense":
        D = model["width"]
        kin = g.feature_dim * g.cells + 2 * len(
            line_cells(g.rows, g.cols, g.win_len))
        linear("stem", D, kin)
        for i in range(model["blocks"]):
            ln(f"block_{i}.ln", D)
            linear(f"block_{i}.fc1", D, D)
            linear(f"block_{i}.fc2", D, D)
        ln("final_ln", D)
        linear("policy_head", A, D)
        linear("value_fc", D // 4, D)
        linear("value_head", 1, D // 4)
        return out
    if model["family"] == "vit":
        E, k = model["embed_dim"], model["patch_size"]
        out.extend([("patch_embed.weight", (E, g.feature_dim, k, k), "lecun"),
                    ("patch_embed.bias", (E,), "zeros"),
                    ("cls_token", (1, 1, E), "normal"),
                    ("pos_embed", (1, g.cells + 1, E), "normal")])
        for i in range(model["depth"]):
            b = f"block_{i}"
            ln(f"{b}.norm1", E)
            for proj in ("query", "key", "value", "out"):
                linear(f"{b}.attn.{proj}", E, E)
            ln(f"{b}.norm2", E)
            linear(f"{b}.mlp_fc1", 4 * E, E)
            linear(f"{b}.mlp_fc2", E, 4 * E)
        ln("norm", E)
        linear("policy_head", A, E)
        linear("value_head", 1, E)
        return out
    raise ValueError(f"no reference network for {model['family']!r}")


@contextlib.contextmanager
def ieee_float32():
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale, back in
    float32."""
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Net:
    """``net(obs (B, F, R, C)) → (probs (B, A), value (B,))`` of a
    configuration's model on parameters ``params``."""

    def __init__(self, model: dict, g: Game, params: dict,
                 precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.model, self.g = model, g
        self.p = {k: v.float() for k, v in params.items()}
        self.q = fp8 if precision == "fp8" else (lambda t: t)
        self.lines = None

    def _linear(self, x, name):
        return F.linear(self.q(x), self.q(self.p[f"{name}.weight"]),
                        self.p[f"{name}.bias"])

    def _ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"],
                            self.p[f"{name}.bias"], LN_EPS)

    @torch.no_grad()
    def __call__(self, obs: torch.Tensor):
        with ieee_float32():
            if self.model["family"] == "dense":
                logits, value = self._dense(obs.float())
            else:
                logits, value = self._vit(obs.float())
        return torch.softmax(logits, -1), value

    def _dense(self, obs):
        g, B = self.g, obs.shape[0]
        if self.lines is None:
            self.lines = g.lines(obs.device)
        flat = obs.reshape(B, -1)
        RC = g.cells
        lf = torch.cat([flat[:, :RC][:, self.lines].sum(-1),
                        flat[:, RC:2 * RC][:, self.lines].sum(-1)], -1)
        h = self._linear(torch.cat([flat, lf / g.win_len], -1), "stem")
        for i in range(self.model["blocks"]):
            y = self._ln(h, f"block_{i}.ln")
            y = torch.relu(self._linear(y, f"block_{i}.fc1"))
            h = h + self._linear(y, f"block_{i}.fc2")
        h = self._ln(h, "final_ln")
        v = torch.relu(self._linear(h, "value_fc"))
        value = torch.tanh(self._linear(v, "value_head"))[:, 0]
        return self._linear(h, "policy_head"), value

    def _vit(self, obs):
        m, g, B = self.model, self.g, obs.shape[0]
        E, H = m["embed_dim"], m["num_heads"]
        Dh = E // H
        k = m["patch_size"]
        h = F.conv2d(self.q(obs), self.q(self.p["patch_embed.weight"]),
                     self.p["patch_embed.bias"], padding=k // 2)
        h = h.permute(0, 2, 3, 1).reshape(B, g.cells, E)
        h = torch.cat([self.p["cls_token"].expand(B, 1, E), h], 1) \
            + self.p["pos_embed"]
        T = h.shape[1]
        for i in range(m["depth"]):
            b = f"block_{i}"
            x = self._ln(h, f"{b}.norm1")
            q, kk, v = (self._linear(x, f"{b}.attn.{n}").reshape(B, T, H, Dh)
                        for n in ("query", "key", "value"))
            q = q / math.sqrt(Dh)
            w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", self.q(q),
                                           self.q(kk)), -1)
            a = torch.einsum("bhqk,bkhd->bqhd", self.q(w), self.q(v))
            h = h + self._linear(a.reshape(B, T, E), f"{b}.attn.out")
            y = F.gelu(self._linear(self._ln(h, f"{b}.norm2"),
                                    f"{b}.mlp_fc1"))
            h = h + self._linear(y, f"{b}.mlp_fc2")
        c = self._ln(h, "norm")[:, 0]
        value = torch.tanh(self._linear(c, "value_head"))[:, 0]
        return self._linear(c, "policy_head"), value
