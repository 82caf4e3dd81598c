"""Convolutional ResNet policy/value towers: the LayerNorm ``ResNet`` and
AlphaZero's batch-norm ``ResNetBN``.

``ResNet`` is the counterpart of the JAX package's flax ``ResNet``: a 3×3
conv stem, blocks of (3×3 conv → per-cell channel LayerNorm → relu → 3×3
conv → LayerNorm, residual, relu), and two 1×1-conv heads.  The convs and
LayerNorms compute in ``dtype`` (bfloat16 by default; LayerNorm statistics
in float32) with float32 parameters, the dense heads in float32, as flax
does.  The forward is plain PyTorch (``F.conv2d``), as the JAX package
leaves it to XLA.

Parameter names follow the flax tree (``stem``, ``stem_ln``,
``block_{i}.conv1/ln1/conv2/ln2``, ``policy_conv``, ``policy_head``,
``value_conv``, ``value_fc``, ``value_head``).  Flax convs are NHWC with
``(kh, kw, in, out)`` kernels; here they are NCHW with ``(out, in, kh, kw)``
weights, so :func:`params_from_flax` transposes each kernel.  The policy
head reads the 1×1 conv's output flattened in NHWC order, as flax's does.

``ResNetBN`` is AlphaZero's network (Silver et al., Science 362:1140,
2018), AlphaGo Zero's tower (Nature 550:354, 2017, Methods): a bias-free
3×3 conv stem → batch norm (BN) → relu, blocks of (3×3 conv → BN → relu →
3×3 conv → BN, residual, relu), a policy head (bias-free 1×1 conv to 2
channels, BN, relu, a linear layer) and a value head (bias-free 1×1 conv
to 1 channel, BN, relu, a linear layer to ``channels``, relu, a linear
layer to one, tanh).  Each BN is an ``nn.BatchNorm2d`` under its names
(``stem_bn``, ``block_{i}.bn1/bn2``, ``policy_bn``, ``value_bn``), its
running statistics persistent float32 buffers that travel with the
parameters in one dict.  The JAX package has no such network.  Inference
folds each BN's running statistics into the convolution before it;
``forward(x, train=True)`` (the learner) normalises by the batch's own
statistics and updates the running ones.  Neither paper gives BN's ε or
momentum: ``nn.BatchNorm2d``'s 1e-5 and 0.1 (with the unbiased variance)
are assumed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from alphazero_tpu_torch.device import ieee_float32_convs

LN_EPS = 1e-6  # flax's LayerNorm default (torch's own default is 1e-5)
BN_EPS = 1e-5       # assumed (nn.BatchNorm2d's)
BN_MOMENTUM = 0.1   # assumed (nn.BatchNorm2d's)


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


def _conv_bn(x, conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype, train: bool):
    """``bn(conv(x))`` of an NCHW tensor in ``dtype``.  In inference the
    running statistics' per-channel scale γ/√(σ²+ε) and shift β − μ·scale
    are folded into the convolution's weights and bias, computed here from
    the tensors so that a captured graph reads their current values.  With
    ``train`` the batch norm runs on the float32 output with the batch's
    own statistics and updates the running ones in place (momentum
    ``BN_MOMENTUM``, the unbiased variance), as ``nn.BatchNorm2d`` does in
    training mode."""
    pad = conv.kernel_size[0] // 2
    if train:
        y = F.conv2d(x, conv.weight.to(dtype), None, padding=pad)
        y = F.batch_norm(y.float(), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, True, BN_MOMENTUM, BN_EPS)
        return y.to(dtype)
    scale = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
    w = conv.weight * scale[:, None, None, None]
    return F.conv2d(x, w.to(dtype), (bn.bias - bn.running_mean * scale)
                    .to(dtype), padding=pad)


def _heads(m, p, v):
    """The float32 dense heads on the relu'd policy map ``p (B, 2, R, C)``
    (flattened NHWC) and value map ``v (B, 1, R, C)``."""
    B = p.shape[0]
    logits = m.policy_head(p.permute(0, 2, 3, 1).reshape(B, -1).float())
    v = F.relu(m.value_fc(v.reshape(B, -1).float()))
    return logits, torch.tanh(m.value_head(v))[:, 0]


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
        dt = self.dtype
        h = F.relu(_ln(_conv(x.to(dt), self.stem, dt), self.stem_ln, dt))
        for i in range(self.blocks):
            h = getattr(self, f"block_{i}")(h, dt)
        return _heads(self, F.relu(_conv(h, self.policy_conv, dt)),
                      F.relu(_conv(h, self.value_conv, dt)))


class BNBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(channels, BN_EPS, BN_MOMENTUM)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(channels, BN_EPS, BN_MOMENTUM)

    def forward(self, x, dtype, train):
        y = F.relu(_conv_bn(x, self.conv1, self.bn1, dtype, train))
        return F.relu(x + _conv_bn(y, self.conv2, self.bn2, dtype, train))


class ResNetBN(nn.Module):
    """AlphaZero's tower.  Input ``(B, F, R, C)`` float32; returns
    ``(logits (B, A), value (B,))``; ``train`` normalises by the batch's
    statistics and updates the running ones."""

    def __init__(self, rows: int, cols: int, action_dim: int,
                 channels_in: int, channels: int = 256, blocks: int = 19,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rows, self.cols = rows, cols
        self.action_dim = action_dim
        self.channels_in = channels_in
        self.channels = channels
        self.blocks = blocks
        self.dtype = dtype
        self.stem = nn.Conv2d(channels_in, channels, 3, padding=1, bias=False)
        self.stem_bn = nn.BatchNorm2d(channels, BN_EPS, BN_MOMENTUM)
        for i in range(blocks):
            self.add_module(f"block_{i}", BNBlock(channels))
        RC = rows * cols
        self.policy_conv = nn.Conv2d(channels, 2, 1, bias=False)
        self.policy_bn = nn.BatchNorm2d(2, BN_EPS, BN_MOMENTUM)
        self.policy_head = nn.Linear(2 * RC, action_dim)
        self.value_conv = nn.Conv2d(channels, 1, 1, bias=False)
        self.value_bn = nn.BatchNorm2d(1, BN_EPS, BN_MOMENTUM)
        self.value_fc = nn.Linear(RC, channels)
        self.value_head = nn.Linear(channels, 1)

    def forward(self, x: torch.Tensor, train: bool = False):
        with ieee_float32_convs():
            dt = self.dtype
            h = F.relu(_conv_bn(x.to(dt), self.stem, self.stem_bn, dt, train))
            for i in range(self.blocks):
                h = getattr(self, f"block_{i}")(h, dt, train)
            p = _conv_bn(h, self.policy_conv, self.policy_bn, dt, train)
            v = _conv_bn(h, self.value_conv, self.value_bn, dt, train)
            return _heads(self, F.relu(p), F.relu(v))


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
