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

import ctypes
import functools
import math

import numpy as np
import torch

from alphazero_tpu_torch.device import ieee_float32_matmuls
from alphazero_tpu_torch.ops.build import (CudaKernel, check, load, plain,
                                          stream)

TAPS = [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)]
LN_EPS = 1e-6
CIN_STEM = 16          # the stem's input channels, zero-padded (a k-step)
MAX_CHANNELS = 128
SMEM_LIMIT = 232_448   # dynamic shared memory one CTA may use on sm_90
WARPS = 16             # warps per CTA of az_resnet_tower


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
    with ieee_float32_matmuls():
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
    with ieee_float32_matmuls():
        p = torch.relu(feat @ pk["pconv_k"] + pk["pconv_b"])       # (B, RC, 2)
        logits = p.reshape(B, RC * 2) @ pk["ph_k"] + pk["ph_b"]
        v = torch.relu(feat @ pk["vconv_k"] + pk["vconv_b"]).reshape(B, RC)
        v = torch.relu(v @ pk["vf_k"] + pk["vf_b"])
        value = torch.tanh(v @ pk["vh_k"] + pk["vh_b"])[:, 0]
    return logits, value


def padded_rows(games: int, RC: int, mt: int) -> int:
    """Rows of a tile of ``games`` games, padded to whole warp items of
    ``mt`` m-tiles of 16 rows."""
    q = 16 * mt
    return -(-games * RC // q) * q


def smem_bytes(games: int, RC: int, C: int, mt: int, stages: int,
               tps: int) -> int:
    """Dynamic shared memory of a tile (as ``csrc/resnet_tower.cu:layout``):
    the float32 residual stream and the bf16 conv input (one more row, the
    zero row), both with 8 columns of padding, the int16 neighbour table and
    ``stages`` stages of ``tps`` taps of C × C bf16 weights."""
    Mp = padded_rows(games, RC, mt)
    r16 = lambda n: -(-n // 16) * 16  # noqa: E731
    return (Mp * (C + 8) * 4 + r16((Mp + 1) * (C + 8) * 2) + r16(9 * Mp * 2)
            + stages * tps * C * C * 2)


# (taps per stage, stages) of the weight ring, in order of preference: a
# CTA waits and synchronises once per stage, which costs more than a
# shallower ring (csrc/resnet_tower.cu gives the measured times)
RINGS = ((9, 2), (3, 3), (3, 2), (1, 3), (1, 2))


def plan(B: int, RC: int, C: int, sms: int) -> dict:
    """Launch geometry of ``az_resnet_tower`` on a card of ``sms``
    streaming multiprocessors: games per CTA, m-tiles per warp (each of the
    16 warps owns at most one item of ``mt`` m-tiles; 2 only at C ≤ 64,
    where a warp's accumulators still fit) and the weight ring.  Where the
    batch fits one wave of ≤ ``sms`` CTAs, the fewest games per CTA that
    give it, with the first of :data:`RINGS` that fits them.  Otherwise the
    ring with the most taps per stage that fits a game, then the most games
    it holds (more waves of whole-conv stages beat fewer of single taps).
    Raises ``ValueError`` when one game does not fit."""
    max_mt = 2 if C <= 64 else 1
    most = min(-(-B // sms), WARPS * 16 * max_mt // RC)

    def fit(games, rings):
        mt = 1 if padded_rows(games, RC, 1) <= WARPS * 16 else 2
        for tps, stages in rings:
            smem = smem_bytes(games, RC, C, mt, stages, tps)
            if smem <= SMEM_LIMIT:
                return {"games": games, "mt": mt, "stages": stages,
                        "taps_per_stage": tps, "smem_bytes": smem,
                        "ctas": -(-B // games)}
        return None

    if most >= 1 and -(-B // most) <= sms:
        one_wave = fit(most, RINGS)
        if one_wave is not None:
            return one_wave
    for taps in sorted({t for t, _ in RINGS}, reverse=True):
        rings = [r for r in RINGS if r[0] == taps]
        for games in range(most, 0, -1):
            pl = fit(games, rings)
            if pl is not None:
                return pl
    need = smem_bytes(1, RC, C, 1, 2, 1)
    raise ValueError(f"one game of {RC} cells at {C} channels needs {need} "
                     f"bytes of shared memory and {RC} rows, over the "
                     f"{SMEM_LIMIT} bytes a CTA may use or the "
                     f"{WARPS * 16 * max_mt} rows of its warps")


def check_shape(rows: int, cols: int, F: int, C: int):
    """Raise ``ValueError`` unless the kernel takes this tower: channels a
    multiple of 16 up to 128, 1 to 16 input planes, one game's activations
    in one CTA's shared memory."""
    if C % 16 or not 16 <= C <= MAX_CHANNELS:
        raise ValueError(f"the fused ResNet tower takes channels a multiple of "
                         f"16 from 16 to {MAX_CHANNELS}, not {C}")
    if not 1 <= F <= CIN_STEM:
        raise ValueError(f"the fused ResNet tower takes 1 to {CIN_STEM} input "
                         f"planes, not {F}")
    plan(1, rows * cols, C, 1)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_P = ctypes.c_void_p
_I = ctypes.c_int

K_TOWER = CudaKernel("resnet_tower.cu", "az_resnet_tower", [
    _P, _I, _I, _I, _I, _I, _I,   # x B F rows cols C nblocks
    _P, _P, _P, _P,               # wstem wblk lns out
    _I, _I, _I, _I, _P])          # games per CTA, m-tiles per warp,
#                                   stages, taps per stage, stream

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
    pl = plan(B, RC, C, sm_count(dev.index if dev.index is not None
                                 else torch.cuda.current_device()))
    out = torch.empty((B, RC, C), dtype=torch.float32, device=dev)
    K_TOWER(x.data_ptr(), B, F, R, Cc, C, nb, packed["wstem"].data_ptr(),
            packed["wblk"].data_ptr(), packed["lns"].data_ptr(),
            out.data_ptr(), pl["games"], pl["mt"], pl["stages"],
            pl["taps_per_stage"], stream(x))
    return out


def geometry(B: int, RC: int, C: int) -> dict:
    """:func:`plan` on the current CUDA device, checked against the
    kernel's own shared-memory layout (needs the CUDA build)."""
    pl = plan(B, RC, C, sm_count(torch.cuda.current_device()))
    lib = load("resnet_tower.cu")
    fn = lib.az_resnet_tower_smem
    fn.argtypes = [_I] * 6
    got = fn(pl["games"], RC, C, pl["mt"], pl["stages"], pl["taps_per_stage"])
    if got != pl["smem_bytes"]:
        raise RuntimeError(f"tower geometry: the kernel reports {got} bytes, "
                           f"the planner {pl}")
    return pl


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
    weights plus one 128-lane-aligned block of activations within 75 MB.
    The kernel computes the LayerNorm tower: a tower without its
    LayerNorms (``models.resnet.ResNetBN``) is refused."""
    if not hasattr(model, "stem_ln"):
        return False
    C = model.channels
    if C % 8 or C < 64:
        return False
    RC = model.rows * model.cols
    weight_bytes = 2 * 9 * C * C * 2 * model.blocks + 2 * 9 * C * 8
    g_align = 128 // math.gcd(RC, 128)
    act_bytes = g_align * RC * (4 * model.channels_in + 64 + 16 * C)
    return weight_bytes + act_bytes <= 75_000_000
