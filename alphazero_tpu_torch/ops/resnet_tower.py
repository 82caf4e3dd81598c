"""The fused ResNet tower for inference: the stem and every residual block
in one kernel launch, the heads in float32 PyTorch.

Counterpart of the JAX package's ``ops/pallas_resnet.py`` (the Pallas
``_kernel``), which the JAX package runs when the user sets
``AZ_FUSED_RESNET=1``; here the opt-in is ``make_eval_fn(...,
fused_resnet=True)``.  What the tower computes is the Pallas kernel's, not
the eager ``models.resnet.ResNet`` forward's: every 3×3 SAME conv reads its
nine neighbours with a cell off the board as zero, the activation rounded to
bf16 at the read and the weights in bf16, products summed in float32; the
LayerNorm over each cell's channels runs in float32 (eps 1e-6); relu; the
residual stream and the output stay float32 (the eager forward rounds the
stream to bf16 after every LayerNorm).  The 1×1-conv heads, the policy
planes flattened in NHWC order, the dense layers and ``tanh`` run outside
the kernel in IEEE float32, as the JAX package runs them in XLA.

The kernel is hand-written CUDA (``csrc/resnet_tower.cu``,
``az_resnet_tower``); :func:`tower_reference` is its plain PyTorch version.
:func:`resnet_tower` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors only.  The layout is the port's own: weights
tap-major ``W[n][t·cin + ci]`` (tap ``t`` in :data:`TAPS` order), the
stem's input channels zero-padded to 16, and the tower's output ``(B, RC,
C)`` float32, games and cells in rows.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import numpy as np
import torch

from alphazero_tpu_torch.ops.build import CudaKernel, check, plain, stream

TAPS = [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)]
LN_EPS = 1e-6
CIN_STEM = 16          # the stem's input channels, zero-padded (a k-step)
MAX_CHANNELS = 128
SMEM_LIMIT = 232_448   # dynamic shared memory one CTA may use on sm_90
WARPS = 8


def neighbour_index(rows: int, cols: int) -> np.ndarray:
    """``(9, RC)`` int64: the cell that tap ``t`` of each cell reads, or
    ``RC`` (a zero row) where that cell lies off the board."""
    RC = rows * cols
    idx = np.full((9, RC), RC, np.int64)
    for cell in range(RC):
        r, c = divmod(cell, cols)
        for t, (dr, dc) in enumerate(TAPS):
            if 0 <= r + dr < rows and 0 <= c + dc < cols:
                idx[t, cell] = (r + dr) * cols + c + dc
    return idx


@torch.no_grad()
def pack(state_dict: dict, blocks: int) -> dict:
    """The ``ResNet``'s parameters → the tower's tap-major bf16 conv
    weights ``wstem (C, 9·16)`` and ``wblk (blocks, 2, C, 9·C)``, its float32
    LayerNorm parameters ``lns (1 + 2·blocks, 2, C)`` (scale, bias) and the
    heads' float32 weights, ``(in, out)`` like the JAX package's."""
    sd = state_dict

    def taps(w, cin_pad=None):          # (out, in, 3, 3) → (out, 9·in)
        t = w.permute(0, 2, 3, 1).float()
        if cin_pad is not None:
            t = torch.nn.functional.pad(t, (0, cin_pad - t.shape[-1]))
        return t.reshape(t.shape[0], -1).to(torch.bfloat16).contiguous()

    def ln(name):
        return torch.stack([sd[f"{name}.weight"], sd[f"{name}.bias"]]).float()

    C = sd["stem.weight"].shape[0]
    dev = sd["stem.weight"].device
    wblk = [torch.stack([taps(sd[f"block_{b}.conv1.weight"]),
                         taps(sd[f"block_{b}.conv2.weight"])])
            for b in range(blocks)]
    lns = [ln("stem_ln")]
    for b in range(blocks):
        lns += [ln(f"block_{b}.ln1"), ln(f"block_{b}.ln2")]
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    return dict(
        wstem=taps(sd["stem.weight"], CIN_STEM),
        wblk=(torch.stack(wblk) if wblk else
              torch.zeros((0, 2, C, 9 * C), dtype=torch.bfloat16,
                          device=dev)),
        lns=torch.stack(lns).contiguous(),
        pconv_k=f32(sd["policy_conv.weight"].reshape(2, C).T),
        pconv_b=f32(sd["policy_conv.bias"]),
        vconv_k=f32(sd["value_conv.weight"].reshape(1, C).T),
        vconv_b=f32(sd["value_conv.bias"]),
        ph_k=f32(sd["policy_head.weight"].T), ph_b=f32(sd["policy_head.bias"]),
        vf_k=f32(sd["value_fc.weight"].T), vf_b=f32(sd["value_fc.bias"]),
        vh_k=f32(sd["value_head.weight"].T), vh_b=f32(sd["value_head.bias"]),
    )


@contextlib.contextmanager
def _ieee_float32_matmuls():
    """The heads and the plain tower multiply in IEEE float32: TF32 off for
    the enclosed products (PyTorch's default, set here so that no caller's
    setting changes the heads)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _bf16(t):
    """Round to bf16 and back: the value the kernel reads."""
    return t.to(torch.bfloat16).float()


def tower_reference(x: torch.Tensor, packed: dict) -> torch.Tensor:
    """Plain PyTorch version of ``az_resnet_tower``: observations ``x (B, F,
    R, C)`` → tower output ``(B, R·C, channels)`` float32.  Each conv is one
    float32 product of the nine neighbour taps (bf16-rounded, zero off the
    board) with the bf16 weights: the products are exact, only the order of
    the float32 sums differs from the kernel's."""
    B, F, R, Cc = x.shape
    RC = R * Cc
    C = packed["wstem"].shape[0]
    idx = torch.as_tensor(neighbour_index(R, Cc), device=x.device)
    lns = packed["lns"]

    def conv(hb, w):
        cin = hb.shape[-1]
        z = torch.cat([hb, hb.new_zeros(B, 1, cin)], dim=1)
        a = z[:, idx].permute(0, 2, 1, 3).reshape(B * RC, 9 * cin)
        return (a @ w.float().T).reshape(B, RC, C)

    def ln(y, i):
        mu = y.mean(-1, keepdim=True)
        var = ((y - mu) ** 2).mean(-1, keepdim=True)
        return (y - mu) * torch.rsqrt(var + LN_EPS) * lns[i, 0] + lns[i, 1]

    xin = x.float().reshape(B, F, RC).transpose(1, 2)
    xin = torch.nn.functional.pad(xin, (0, CIN_STEM - F))
    with _ieee_float32_matmuls():
        h = torch.relu(ln(conv(_bf16(xin), packed["wstem"]), 0))
        for b in range(packed["wblk"].shape[0]):
            y = torch.relu(ln(conv(_bf16(h), packed["wblk"][b, 0]), 1 + 2 * b))
            y = ln(conv(_bf16(y), packed["wblk"][b, 1]), 2 + 2 * b)
            h = torch.relu(h + y)
    return h


def heads(feat: torch.Tensor, packed: dict):
    """The policy and value heads on the tower output ``feat (B, RC, C)``:
    ``(logits (B, A), value (B,))`` in IEEE float32.  The policy planes are
    flattened cell-major, channel-minor (NHWC), as flax's."""
    B, RC, _ = feat.shape
    pk = packed
    with _ieee_float32_matmuls():
        p = torch.relu(feat @ pk["pconv_k"] + pk["pconv_b"])       # (B, RC, 2)
        logits = p.reshape(B, RC * 2) @ pk["ph_k"] + pk["ph_b"]
        v = torch.relu(feat @ pk["vconv_k"] + pk["vconv_b"]).reshape(B, RC)
        v = torch.relu(v @ pk["vf_k"] + pk["vf_b"])
        value = torch.tanh(v @ pk["vh_k"] + pk["vh_b"])[:, 0]
    return logits, value


def smem_bytes(games: int, RC: int, C: int) -> int:
    """Dynamic shared memory of a tile of ``games`` games (as
    ``csrc/resnet_tower.cu:layout``): h and y float32, the bf16 copy with
    8 columns of padding, the int16 neighbour table."""
    M16 = -(-games * RC // 16) * 16
    return M16 * C * 8 + M16 * (C + 8) * 2 + 9 * M16 * 2


def check_shape(rows: int, cols: int, F: int, C: int):
    """Raise ``ValueError`` unless the kernel takes this tower: channels a
    multiple of 16 up to 128, 1 to 16 input planes, one game's activations
    in one CTA's shared memory."""
    RC = rows * cols
    if C % 16 or not 16 <= C <= MAX_CHANNELS:
        raise ValueError(f"the fused ResNet tower takes channels a multiple of "
                         f"16 from 16 to {MAX_CHANNELS}, not {C}")
    if not 1 <= F <= CIN_STEM:
        raise ValueError(f"the fused ResNet tower takes 1 to {CIN_STEM} input "
                         f"planes, not {F}")
    if smem_bytes(1, RC, C) > SMEM_LIMIT:
        raise ValueError(f"one {rows}x{cols} game at {C} channels needs "
                         f"{smem_bytes(1, RC, C)} bytes of shared memory, "
                         f"over the {SMEM_LIMIT} a CTA may use")


def plan_games(B: int, RC: int, C: int) -> int:
    """Games per CTA: enough 16-row × 32-channel tiles to give each of the 8
    warps one, but no fewer CTAs than SMs (132) where the batch allows, and
    within shared memory."""
    groups = -(-C // 32)
    g = -(-WARPS * 16 // (groups * RC))
    g = max(1, min(g, B // 132))
    while g > 1 and smem_bytes(g, RC, C) > SMEM_LIMIT:
        g -= 1
    return g


_P = ctypes.c_void_p
_I = ctypes.c_int

K_TOWER = CudaKernel("resnet_tower.cu", "az_resnet_tower", [
    _P, _I, _I, _I, _I, _I, _I,   # x B F rows cols C nblocks
    _P, _P, _P, _P,               # wstem wblk lns out
    _I, _P])                      # games per CTA, stream

KERNELS = [K_TOWER]


def resnet_tower(x: torch.Tensor, packed: dict) -> torch.Tensor:
    """``az_resnet_tower`` for CUDA tensors, :func:`tower_reference` for CPU
    tensors: observations ``x (B, F, R, C)`` float32 → ``(B, R·C, C)``."""
    if plain(x):
        return tower_reference(x, packed)
    B, F, R, Cc = x.shape
    RC = R * Cc
    C = packed["wstem"].shape[0]
    nb = packed["wblk"].shape[0]
    check_shape(R, Cc, F, C)
    dev = x.device
    check(x, torch.float32, (B, F, R, Cc), dev, "x")
    check(packed["wstem"], torch.bfloat16, (C, 9 * CIN_STEM), dev, "wstem")
    check(packed["wblk"], torch.bfloat16, (nb, 2, C, 9 * C), dev, "wblk")
    check(packed["lns"], torch.float32, (1 + 2 * nb, 2, C), dev, "lns")
    out = torch.empty((B, RC, C), dtype=torch.float32, device=dev)
    K_TOWER(x.data_ptr(), B, F, R, Cc, C, nb, packed["wstem"].data_ptr(),
            packed["wblk"].data_ptr(), packed["lns"].data_ptr(),
            out.data_ptr(), plan_games(B, RC, C), stream(x))
    return out


def make_fused_apply(geometry, channels: int, blocks: int):
    """``fused(params, obs (B, F, R, C)) → (logits, value)`` through the
    fused tower, with ``fused.pack(params)`` and ``fused.apply_packed(packed,
    obs)`` for callers that evaluate many times with the same weights.
    ``geometry`` is an env or a ``ResNet`` (rows, cols and ``feature_dim`` or
    ``channels_in``).  Raises ``ValueError`` for a tower the kernel does not
    take; it never runs another forward in its place."""
    F = getattr(geometry, "feature_dim", None) or geometry.channels_in
    check_shape(geometry.rows, geometry.cols, F, channels)

    def pack_params(params):
        return pack(params, blocks)

    @torch.no_grad()
    def apply_packed(packed, obs):
        return heads(resnet_tower(obs, packed), packed)

    def fused(params, obs):
        return apply_packed(pack_params(params), obs)

    fused.pack = pack_params
    fused.apply_packed = apply_packed
    return fused


def supports_fused_resnet(model) -> bool:
    """Whether the JAX package would give this ``ResNet`` the fused tower
    when opted in: its shape arithmetic (``ops/pallas_resnet.py``
    ``supports_fused_resnet``), without the environment read and the
    platform check.  Channels a multiple of 8 and at least 64, and the
    weights plus one 128-lane-aligned block of activations within 75 MB."""
    C = model.channels
    if C % 8 or C < 64:
        return False
    RC = model.rows * model.cols
    weight_bytes = 2 * 9 * C * C * 2 * model.blocks + 2 * 9 * C * 8
    g_align = 128 // math.gcd(RC, 128)
    act_bytes = g_align * RC * (4 * model.channels_in + 64 + 16 * C)
    return weight_bytes + act_bytes <= 75_000_000
