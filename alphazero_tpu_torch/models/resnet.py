"""Convolutional ResNet policy/value tower.

Counterpart of the JAX package's flax ``ResNet``: a 3×3 conv stem, blocks
of (3×3 conv → per-cell channel LayerNorm → relu → 3×3 conv → LayerNorm,
residual, relu), and two 1×1-conv heads.  The convs and LayerNorms compute
in ``dtype`` (bfloat16 by default; LayerNorm statistics in float32) with
float32 parameters, the dense heads in float32, as flax does.  The forward
is plain PyTorch (``F.conv2d``), as the JAX package leaves it to XLA.

Parameter names follow the flax tree (``stem``, ``stem_ln``,
``block_{i}.conv1/ln1/conv2/ln2``, ``policy_conv``, ``policy_head``,
``value_conv``, ``value_fc``, ``value_head``).  Flax convs are NHWC with
``(kh, kw, in, out)`` kernels; here they are NCHW with ``(out, in, kh, kw)``
weights, so :func:`params_from_flax` transposes each kernel.  The policy
head reads the 1×1 conv's output flattened in NHWC order, as flax's does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from alphazero_tpu_torch.device import ieee_float32_convs

LN_EPS = 1e-6  # flax's LayerNorm default (torch's own default is 1e-5)


def _conv(x, conv: nn.Conv2d, dtype):
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x, conv.weight.to(dtype), bias,
                    padding=conv.kernel_size[0] // 2)


def _ln(x, ln: nn.LayerNorm, dtype):
    """LayerNorm over the channels of each cell of an NCHW tensor, with
    float32 statistics, cast to ``dtype``."""
    y = F.layer_norm(x.float().permute(0, 2, 3, 1), ln.normalized_shape,
                     ln.weight, ln.bias, LN_EPS)
    return y.permute(0, 3, 1, 2).to(dtype)


class ResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.ln1 = nn.LayerNorm(channels, eps=LN_EPS)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.ln2 = nn.LayerNorm(channels, eps=LN_EPS)

    def forward(self, x, dtype):
        y = F.relu(_ln(_conv(x, self.conv1, dtype), self.ln1, dtype))
        y = _ln(_conv(y, self.conv2, dtype), self.ln2, dtype)
        return F.relu(x + y)


class ResNet(nn.Module):
    """Input ``(B, F, R, C)`` float32; returns ``(logits (B, A), value (B,))``."""

    def __init__(self, rows: int, cols: int, action_dim: int,
                 channels_in: int, channels: int = 64, blocks: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rows, self.cols = rows, cols
        self.action_dim = action_dim
        self.channels_in = channels_in
        self.channels = channels
        self.blocks = blocks
        self.dtype = dtype
        self.stem = nn.Conv2d(channels_in, channels, 3, padding=1, bias=False)
        self.stem_ln = nn.LayerNorm(channels, eps=LN_EPS)
        for i in range(blocks):
            self.add_module(f"block_{i}", ResBlock(channels))
        RC = rows * cols
        self.policy_conv = nn.Conv2d(channels, 2, 1)
        self.policy_head = nn.Linear(2 * RC, action_dim)
        self.value_conv = nn.Conv2d(channels, 1, 1)
        self.value_fc = nn.Linear(RC, channels)
        self.value_head = nn.Linear(channels, 1)

    def forward(self, x: torch.Tensor):
        with ieee_float32_convs():
            return self._forward(x)

    def _forward(self, x):
        B = x.shape[0]
        dt = self.dtype
        h = F.relu(_ln(_conv(x.to(dt), self.stem, dt), self.stem_ln, dt))
        for i in range(self.blocks):
            h = getattr(self, f"block_{i}")(h, dt)
        # heads: NHWC flattening, then float32 dense layers
        p = F.relu(_conv(h, self.policy_conv, dt))
        p = p.permute(0, 2, 3, 1).reshape(B, -1).float()
        logits = self.policy_head(p)
        v = F.relu(_conv(h, self.value_conv, dt)).reshape(B, -1).float()
        v = F.relu(self.value_fc(v))
        value = torch.tanh(self.value_head(v))[:, 0]
        return logits, value


def params_from_flax(params_np) -> dict:
    """Flax ``ResNet`` parameter tree (numpy leaves) → this module's
    ``state_dict``: conv kernels ``(kh, kw, in, out)`` → ``(out, in, kh,
    kw)``, dense kernels ``(in, out)`` → ``(out, in)``, LayerNorm ``scale``
    → ``weight``."""
    out = {}

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def put(prefix, p):
        if "scale" in p:
            out[f"{prefix}.weight"] = t(p["scale"])
        else:
            k = np.asarray(p["kernel"], np.float32)
            out[f"{prefix}.weight"] = t(k.transpose(3, 2, 0, 1) if k.ndim == 4
                                        else k.T)
        if "bias" in p:
            out[f"{prefix}.bias"] = t(p["bias"])

    for key, sub in params_np.items():
        if key.startswith("block_"):
            for name, p in sub.items():
                put(f"{key}.{name}", p)
        else:
            put(key, sub)
    return out
