"""Vision-Transformer policy/value network.

Counterpart of the JAX package's flax ``ViT``: a stride-1 conv patch
embedding padded by ``patch_size // 2`` (so there are ``rows·cols``
patches, in the row-major order of the board), a CLS token first and a
learned position embedding, ``depth`` pre-norm attention blocks with an
exact-GELU 4× MLP, a final LayerNorm, and a float32 linear policy head and
tanh value head on the CLS row.  Activations compute in ``dtype``
(bfloat16 by default; LayerNorm statistics in float32) with float32
parameters, as flax does.  The forward is plain PyTorch: the JAX package
leaves the ViT to XLA.

The attention is written out as flax's ``MultiHeadDotProductAttention``
computes it, where ``F.scaled_dot_product_attention`` would differ: the
query is divided by √Dh before the product, the softmax runs in ``dtype``,
and the attention-weight dropout draws ONE ``(T, T)`` mask per call,
shared by every game and head (flax's ``broadcast_dropout``).  Dropout
keeps ``x / keep`` and draws its masks from the ``dropout_generator`` the
caller passes (``torch.rand``, since ``F.dropout`` takes no generator); no
generator is flax's ``deterministic=True``.

Parameter names follow the flax tree (``patch_embed``, ``cls_token``,
``pos_embed``, ``block_{i}.norm1/attn.{query,key,value,out}/norm2/
mlp_fc1/mlp_fc2``, ``norm``, ``policy_head``, ``value_head``), so that
:func:`params_from_flax` is a mechanical mapping and depth surgery matches
blocks by name.  The attention projections are ``nn.Linear(E, E)``: flax's
``(E, H, Dh)`` query/key/value kernels and ``(H, Dh, E)`` out kernel,
flattened and transposed.

The search evaluates it through ``models.make_eval_fn``'s
``Evaluator``: on the card, from a batch shape's ``CAPTURE_AT``-th call
on, the forward is replayed as a CUDA graph of these same kernels (the
host no longer launches its ops one by one); each call returns fresh
copies of the graph's outputs, and the graph reads the parameter
tensors the evaluator was built with.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from alphazero_tpu_torch.device import (ieee_float32_convs,
                                        ieee_float32_matmuls)
from alphazero_tpu_torch.models.dense import LN_EPS


def _ln(x, ln: nn.LayerNorm, dtype):
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        LN_EPS).to(dtype)


def _linear(x, lin: nn.Linear, dtype):
    return F.linear(x, lin.weight.to(dtype), lin.bias.to(dtype))


def _keep_mask(shape, rate, generator, device):
    """Bernoulli(1 - rate) keep mask of ``shape`` drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def _keep_rate(rate, dtype):
    """``1 - rate`` in ``dtype``, as flax divides by it."""
    return torch.tensor(1.0 - rate, dtype=dtype)


def _dropout(x, rate, generator):
    """Flax's ``nn.Dropout``: ``x / keep`` where kept, else 0."""
    if generator is None or rate == 0.0:
        return x
    keep = _keep_mask(x.shape, rate, generator, x.device)
    return torch.where(keep, x / _keep_rate(rate, x.dtype),
                       torch.zeros_like(x))


class Attention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        for name in ("query", "key", "value", "out"):
            self.add_module(name, nn.Linear(embed_dim, embed_dim))

    def forward(self, x, dtype, generator=None):
        B, T, E = x.shape
        y = _attend(self, x, E // self.num_heads, dtype, generator)
        return _linear(y.reshape(B, T, E), self.out, dtype)


def _attend(attn, x, head_dim, dtype, generator):
    """Flax's attention core over the heads of ``attn``'s query, key and
    value projections of ``x (B, T, E)`` → ``(B, T, heads, head_dim)``:
    the query scaled by √Dh first, the softmax in ``dtype``, one ``(T, T)``
    dropout mask for every game and head."""
    B, T = x.shape[:2]
    q, k, v = (_linear(x, getattr(attn, n), dtype).reshape(B, T, -1, head_dim)
               for n in ("query", "key", "value"))
    q = q / torch.tensor(math.sqrt(head_dim), dtype=dtype)
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
    if generator is not None and attn.dropout > 0.0:
        keep = _keep_mask((T, T), attn.dropout, generator, x.device)
        w = w * (keep.to(dtype) / _keep_rate(attn.dropout, dtype))
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


class AttentionBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.norm1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.attn = Attention(embed_dim, num_heads, dropout)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(embed_dim, 4 * embed_dim)
        self.mlp_fc2 = nn.Linear(4 * embed_dim, embed_dim)

    def forward(self, x, dtype, generator=None):
        x = x + self.attn(_ln(x, self.norm1, dtype), dtype, generator)
        y = F.gelu(_linear(_ln(x, self.norm2, dtype), self.mlp_fc1, dtype))
        y = _dropout(y, self.dropout, generator)
        y = _dropout(_linear(y, self.mlp_fc2, dtype), self.dropout, generator)
        return x + y


class ViT(nn.Module):
    """Input ``(B, F, R, C)`` float32; returns ``(logits (B, A), value (B,))``.
    ``forward(x, dropout_generator)`` trains with dropout on; without a
    generator the forward is deterministic."""

    def __init__(self, rows: int, cols: int, action_dim: int, channels: int,
                 embed_dim: int = 512, patch_size: int = 5,
                 num_heads: int = 8, depth: int = 1, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rows, self.cols = rows, cols
        self.action_dim = action_dim
        self.channels = channels
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.num_heads = num_heads
        self.depth = depth
        self.dropout = dropout
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(channels, embed_dim, patch_size,
                                     padding=patch_size // 2)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, rows * cols + 1,
                                                  embed_dim))
        for i in range(depth):
            self.add_module(f"block_{i}",
                            AttentionBlock(embed_dim, num_heads, dropout))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.policy_head = nn.Linear(embed_dim, action_dim)
        self.value_head = nn.Linear(embed_dim, 1)

    def forward(self, x: torch.Tensor, dropout_generator=None):
        # float32 configs stay IEEE float32: no TF32 in the conv or matmuls
        with ieee_float32_convs(), ieee_float32_matmuls():
            return self._forward(x, dropout_generator)

    def _forward(self, x, generator):
        B, E, dt = x.shape[0], self.embed_dim, self.dtype
        conv = self.patch_embed
        h = F.conv2d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                     padding=self.patch_size // 2)
        h = h.permute(0, 2, 3, 1).reshape(B, self.rows * self.cols, E)
        cls = self.cls_token.to(dt).expand(B, 1, E)
        h = torch.cat([cls, h], dim=1) + self.pos_embed.to(dt)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, dt, generator)
        cls_out = _ln(h, self.norm, dt)[:, 0].float()
        logits = self.policy_head(cls_out)
        value = torch.tanh(self.value_head(cls_out))[:, 0]
        return logits, value


def params_from_flax(params_np) -> dict:
    """Flax ``ViT`` parameter tree (numpy leaves) → this module's
    ``state_dict``: the conv kernel ``(kh, kw, in, out)`` → ``(out, in, kh,
    kw)``; dense kernels ``(in, out)`` → ``(out, in)``; the attention's
    ``(E, H, Dh)`` kernels and ``(H, Dh)`` biases flattened to ``(E, E)``
    and ``(E,)``, its ``(H, Dh, E)`` out kernel to ``(E, E)``; LayerNorm
    ``scale`` → ``weight``."""
    out = {}

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def put(prefix, p):
        if "scale" in p:
            out[f"{prefix}.weight"] = t(p["scale"])
            out[f"{prefix}.bias"] = t(p["bias"])
            return
        k = np.asarray(p["kernel"], np.float32)
        if k.ndim == 4:
            w = k.transpose(3, 2, 0, 1)
        elif k.ndim == 3 and prefix.endswith(".out"):     # (H, Dh, E)
            w = k.reshape(-1, k.shape[-1]).T
        else:                                             # (E, ...) kernels
            w = k.reshape(k.shape[0], -1).T
        out[f"{prefix}.weight"] = t(w)
        out[f"{prefix}.bias"] = t(np.asarray(p["bias"]).reshape(-1))

    for key, sub in params_np.items():
        if key in ("cls_token", "pos_embed"):
            out[key] = t(sub)
        elif key.startswith("block_"):
            for name, p in sub.items():
                if name == "attn":
                    for proj, q in p.items():
                        put(f"{key}.attn.{proj}", q)
                else:
                    put(f"{key}.{name}", p)
        else:
            put(key, sub)
    return out
