"""Dense policy/value tower for small boards.

Counterpart of the JAX package's flax ``DenseTower``: the input planes plus
the per-plane win-line occupancy sums (divided by ``win_len``) go through a
stem, ``blocks`` pre-LayerNorm residual MLP blocks and a final LayerNorm;
the policy head, ``value_fc`` and ``value_head`` run in float32.

Parameter names follow the flax tree (``stem``, ``block_{i}.ln/fc1/fc2``,
``final_ln``, ``policy_head``, ``value_fc``, ``value_head``) so that
:func:`params_from_flax` is a renaming plus a transpose of each kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from alphazero_tpu_torch.envs.core import line_cells

LN_EPS = 1e-6  # flax's LayerNorm default (torch's own default is 1e-5)


class DenseBlock(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.ln = nn.LayerNorm(width, eps=LN_EPS)
        self.fc1 = nn.Linear(width, width)
        self.fc2 = nn.Linear(width, width)

    def forward(self, x, dtype):
        y = F.layer_norm(x.float(), self.ln.normalized_shape, self.ln.weight,
                         self.ln.bias, LN_EPS).to(dtype)
        y = F.relu(F.linear(y, self.fc1.weight.to(dtype),
                            self.fc1.bias.to(dtype)))
        y = F.linear(y, self.fc2.weight.to(dtype), self.fc2.bias.to(dtype))
        return x + y


class DenseTower(nn.Module):
    """Input ``(B, F, R, C)`` float32; returns ``(logits (B, A), value (B,))``.

    ``dtype`` is the compute type of the stem, blocks and final LayerNorm
    (LayerNorm statistics are taken in float32); the heads are float32.
    """

    def __init__(self, rows: int, cols: int, action_dim: int,
                 channels_in: int, win_len: int, width: int = 512,
                 blocks: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rows, self.cols = rows, cols
        self.action_dim = action_dim
        self.channels_in = channels_in
        self.win_len = win_len
        self.width = width
        self.blocks = blocks
        self.dtype = dtype
        lines = line_cells(rows, cols, win_len)
        self.register_buffer("lines", torch.as_tensor(lines, dtype=torch.long),
                             persistent=False)
        self.in_features = channels_in * rows * cols + 2 * lines.shape[0]
        self.stem = nn.Linear(self.in_features, width)
        for i in range(blocks):
            self.add_module(f"block_{i}", DenseBlock(width))
        self.final_ln = nn.LayerNorm(width, eps=LN_EPS)
        self.policy_head = nn.Linear(width, action_dim)
        self.value_fc = nn.Linear(width, width // 4)
        self.value_head = nn.Linear(width // 4, 1)

    def line_features(self, flat_obs: torch.Tensor) -> torch.Tensor:
        """``(B, F·RC)`` → ``(B, 2L)``: win-line sums of planes 0 and 1,
        divided by ``win_len`` (exact for 0/1 planes)."""
        RC = self.rows * self.cols
        mine = flat_obs[:, :RC][:, self.lines].sum(-1)
        theirs = flat_obs[:, RC:2 * RC][:, self.lines].sum(-1)
        return torch.cat([mine, theirs], dim=-1) / self.win_len

    def forward(self, x: torch.Tensor):
        B = x.shape[0]
        flat = x.reshape(B, -1).float()
        h = torch.cat([flat, self.line_features(flat)], dim=-1)
        dt = self.dtype
        h = F.linear(h.to(dt), self.stem.weight.to(dt), self.stem.bias.to(dt))
        for i in range(self.blocks):
            h = getattr(self, f"block_{i}")(h, dt)
        h32 = F.layer_norm(h.float(), self.final_ln.normalized_shape,
                           self.final_ln.weight, self.final_ln.bias, LN_EPS)
        logits = self.policy_head(h32)
        v = F.relu(self.value_fc(h32))
        value = torch.tanh(self.value_head(v))[:, 0]
        return logits, value


def params_from_flax(params_np) -> dict:
    """Flax parameter tree (numpy leaves) → this module's ``state_dict``.

    Flax ``Dense.kernel`` is ``(in, out)``; ``nn.Linear.weight`` is
    ``(out, in)``.  LayerNorm ``scale`` becomes ``weight``.
    """
    out = {}

    def dense(prefix, p):
        out[f"{prefix}.weight"] = torch.tensor(
            np.asarray(p["kernel"], np.float32).T)
        out[f"{prefix}.bias"] = torch.tensor(np.asarray(p["bias"], np.float32))

    def ln(prefix, p):
        out[f"{prefix}.weight"] = torch.tensor(np.asarray(p["scale"], np.float32))
        out[f"{prefix}.bias"] = torch.tensor(np.asarray(p["bias"], np.float32))

    for key, sub in params_np.items():
        if key.startswith("block_"):
            ln(f"{key}.ln", sub["ln"])
            dense(f"{key}.fc1", sub["fc1"])
            dense(f"{key}.fc2", sub["fc2"])
        elif key == "final_ln":
            ln(key, sub)
        else:
            dense(key, sub)
    return out
