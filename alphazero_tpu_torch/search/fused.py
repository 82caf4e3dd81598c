"""MCTS with the dense network: the whole-chunk self-play and the move search.

Counterpart of the JAX package's ``search/pallas_fused.py``
(``run_selfplay_chunk_fused`` with its Pallas ``_chunk_kernel``, and
``run_mcts_fused`` with its Pallas ``_move_kernel``).  Per chunk move, for
all B games:

  root observation → dense forward → Dirichlet mix → legal mask → tree init
  → S−1 × (PUCT descent with the leaf board built in the walk → dense
  forward of the leaf → expansion + backup) → root visit counts → action
  (inverse-CDF sample on a supplied uniform before ``temperature_moves``,
  first argmax after) → env step → records → reset of finished games →
  the next move's root observation.

The root observation of the chunk's first move has a stage of its own;
the tail of each move writes that of the next one.

The move search (:func:`run_mcts_fused`, what the arena and the gate run)
evaluates and mixes the root on the host, initialises the tree from that
prior with finished games left unexpanded, runs the same S−1 simulations
and returns the root counts, policy and root Q.  On the card, with their
own forward, both replay each move's simulations as one CUDA graph per
search shape (:class:`MoveGraphs`).

Both serve every game whose board and actions the kernels take, with the
game's move rules (``env.rules``): connect4's gravity, tictactoe's empty
cells, gomoku's neighbourhood with the centre as the only opening.  The
legal mask is the JAX kernels' rule (``pallas_fused.py:884-898``,
``pallas_mcts._leaf_finish``): column heights under gravity, else the
env's ``valid_mask_board``, which gives the same bits.
:func:`supports_chunk` is the static gate that the self-play runner and
``run_mcts`` consult.

Each stage is a hand-written CUDA kernel (``csrc/search.cu``,
``csrc/dense_forward.cu``) with its plain PyTorch version beside it in this
module.  A wrapper runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  :func:`run_selfplay_chunk`
and :func:`run_mcts_fused` sequence the stages from the host.  The two
kernels of every simulation, the descent and the apply, the two at the
ends of a chunk move, the tree init and the tail, and the move search's
root counts give each game a group of G lanes (8, 16 or 32 from the action
count): the walk reads a node's A edges across the group and reduces them
to the first maximum, the leaf finish and the expansion spread their
cells, lines, actions and plies over it, the tree init its edges and tree
rows, the tail and the root counts the root's counts (summed over the
group), the tail its records, board and the next root's observation; the
tail's inverse-CDF sum alone stays serial, its bits depend on the order
(:func:`search_geometry`, the ``search.cu`` header).  The move search's
tree init is elementwise (16-byte stores of the tree rows, lanes over the
root's edges), the first move's root observation a thread per element.

The tree lives in device memory with games in rows: ``visit``/``val``
``(B, N)`` float32 with N = S+1, edges ``child (B, N, A)`` int32 (node id,
-1 = no child yet, -2 = illegal action) and ``prior (B, N, A)`` float32, the
path ``(B, dcap)``.  ``visit`` holds ``visits + 0.5·expanded`` (exact in
float32).  Priors are quantized to the 2⁻¹⁴ grid, ``floor(p·16384+0.5)/16384``,
as the Pallas kernel's packed edges store them: the quantization is part of
the search semantics.  The JAX kernel's d0/d1/d2 peel mirrors, dead-row
backup, sim-loop segmentation and half-batch pipelining give the same bits
as a plain tree walk and have no counterpart here.

Search arithmetic (Dirichlet mix, UCB, backup, the inverse-CDF sum) is
float32 with every operation rounded on its own — the CUDA source is built
with ``-fmad=false`` — so kernel and plain version agree bit for bit.  The
dense forward multiplies in bfloat16 with float32 sums and agrees to a
stated tolerance.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import numpy as np
import torch

from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.device import resolve_device
from alphazero_tpu_torch.envs.core import (RULES_GRAVITY,
                                           RULES_NEIGHBOURHOOD,
                                           _make_line_matrix, line_cells)
from alphazero_tpu_torch.models.dense import DenseTower
from alphazero_tpu_torch.ops.build import CudaKernel, check, plain, stream
from alphazero_tpu_torch.ops.build import load as load_lib
from alphazero_tpu_torch.ops.graphs import GraphCache
from alphazero_tpu_torch.search.mcts import (NEG, SearchResult,
                                             dirichlet_noise, first_argmax,
                                             root_prior, search_inputs)
from alphazero_tpu_torch.utils.profiling import span

NO_CHILD = -1
ILLEGAL = -2
# boards the search kernels take (csrc/search.cu: the walk's board is two
# planes of at most 256 cells, connect4's heights at most 32 columns)
SEARCH_MAX_CELLS = 256
SEARCH_MAX_COLS = 32
# columns of the pending-leaf record written by the descent
P_DEPTH, P_PARENT, P_ACTION, P_ALLOC, P_LEAF, P_TERMINAL, P_WON = range(7)
PEND_COLS = 7
# threads per CTA of the search kernels (csrc/search.cu: kThreads)
SEARCH_THREADS = 128


def game_tables(env) -> dict:
    """Constant tables of a game, the JAX kernels' ``_game_tables``: the
    line matrix ``W (RC, L)``, its cells ``lines (L, win_len)`` and ``aux``,
    the matrix of the legal mask: connect4's column matrix ``(C, RC)``,
    gomoku's 8-neighbourhood ``(RC, RC)`` (each cell with itself), a zero
    row ``(1, RC)`` for tictactoe.  The CUDA kernels take the move rules
    (``env.rules``) in place of ``aux``."""
    R, C = env.rows, env.cols
    RC = R * C
    W = _make_line_matrix(R, C, env.win_len)
    if env.rules == RULES_GRAVITY:
        aux = np.zeros((C, RC), np.float32)
        for c in range(C):
            aux[c, c::C] = 1.0
    elif env.rules == RULES_NEIGHBOURHOOD:
        aux = np.zeros((RC, RC), np.float32)
        for r in range(R):
            for c in range(C):
                for rr in range(max(r - 1, 0), min(r + 2, R)):
                    aux[r * C + c,
                        rr * C + max(c - 1, 0):rr * C + min(c + 2, C)] = 1.0
    else:
        aux = np.zeros((1, RC), np.float32)
    return {"W": W.astype(np.float32), "lines": line_cells(R, C, env.win_len),
            "aux": aux}


def qprior(p: torch.Tensor) -> torch.Tensor:
    """Quantize priors to the 2⁻¹⁴ grid (the Pallas kernel's ``_qfrac``·2)."""
    return torch.floor(p * 16384.0 + 0.5) * (1.0 / 16384.0)


# ---------------------------------------------------------------------------
# dense forward
# ---------------------------------------------------------------------------

def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def pack_dense_params(model, params: dict, device=None) -> dict:
    """``state_dict`` → the forward kernel's operands.

    Matrix weights of the stem, the blocks and ``value_fc`` are bfloat16
    ``(out, in)``; the stem's input width is padded with zero columns to a
    multiple of 16.  LayerNorm, biases and the policy and value heads stay
    float32.  Block tensors are stacked along a leading ``blocks`` axis.
    """
    dev = device if device is not None else params["stem.weight"].device

    def f32(name):
        return params[name].detach().to(dev, torch.float32).contiguous()

    def bf16(w):
        return w.to(torch.bfloat16).contiguous()

    stem = f32("stem.weight")
    kin = stem.shape[1]
    stem_p = torch.zeros((stem.shape[0], _pad16(kin)), dtype=torch.float32,
                         device=dev)
    stem_p[:, :kin] = stem
    nb = model.blocks
    blk = [f"block_{i}" for i in range(nb)]
    return {
        "stem_w": bf16(stem_p), "stem_b": f32("stem.bias"),
        "ln_s": torch.stack([f32(f"{b}.ln.weight") for b in blk]),
        "ln_b": torch.stack([f32(f"{b}.ln.bias") for b in blk]),
        "w1": bf16(torch.stack([f32(f"{b}.fc1.weight") for b in blk])),
        "b1": torch.stack([f32(f"{b}.fc1.bias") for b in blk]),
        "w2": bf16(torch.stack([f32(f"{b}.fc2.weight") for b in blk])),
        "b2": torch.stack([f32(f"{b}.fc2.bias") for b in blk]),
        "fln_s": f32("final_ln.weight"), "fln_b": f32("final_ln.bias"),
        "pol_w": f32("policy_head.weight"), "pol_b": f32("policy_head.bias"),
        "vfc_w": bf16(f32("value_fc.weight")), "vfc_b": f32("value_fc.bias"),
        "vh_w": f32("value_head.weight").reshape(-1),
        "vh_b": f32("value_head.bias"),
        "lines": torch.as_tensor(model.lines.cpu().numpy(), dtype=torch.int32,
                                 device=dev),
        "win_len": model.win_len,
        "rc": model.rows * model.cols,
        "kin": kin,
    }


def _ln(h, s, b, eps=1e-6):
    mu = h.mean(dim=-1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
    return (h - mu) * torch.rsqrt(var + eps) * s + b


def _mm_bf16(x, w):
    """``x (B, I) @ w (O, I)ᵀ`` with both operands rounded to bfloat16 and
    float32 sums (bf16 products are exact in float32)."""
    return x.to(torch.bfloat16).float() @ w.float().T


def dense_forward_reference(obs: torch.Tensor, packed: dict):
    """Plain version of the forward inside the chunk kernel.

    ``obs (B, F·RC)`` float32 → ``probs (B, A)`` (softmax over all actions)
    and ``value (B,)``.  The semantics are the Pallas kernel's
    ``_dense_forward``: line features ``W_linesᵀ·plane / win_len``; stem,
    fc1, fc2 and ``value_fc`` take bfloat16 operands with float32 sums; the
    policy and value heads are float32 products; LayerNorm eps is 1e-6.
    """
    RC, K = packed["rc"], packed["win_len"]
    idx = packed["lines"].long()
    lm = obs[:, :RC][:, idx].sum(-1) / K
    lt = obs[:, RC:2 * RC][:, idx].sum(-1) / K
    x = torch.cat([obs, lm, lt], dim=-1)
    kp = packed["stem_w"].shape[1]
    x = torch.nn.functional.pad(x, (0, kp - x.shape[1]))
    h = _mm_bf16(x, packed["stem_w"]) + packed["stem_b"]
    for i in range(packed["w1"].shape[0]):
        y = _ln(h, packed["ln_s"][i], packed["ln_b"][i])
        y = torch.relu(_mm_bf16(y, packed["w1"][i]) + packed["b1"][i])
        y = _mm_bf16(y, packed["w2"][i]) + packed["b2"][i]
        h = h + y
    h = _ln(h, packed["fln_s"], packed["fln_b"])
    logits = h @ packed["pol_w"].T + packed["pol_b"]
    v = torch.relu(_mm_bf16(h, packed["vfc_w"]) + packed["vfc_b"])
    value = torch.tanh(v @ packed["vh_w"] + packed["vh_b"])
    return torch.softmax(logits, dim=-1), value


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# launch geometry of az_dense_forward (csrc/dense_forward.cu)
DENSE_COLS = 64          # output columns of each layer per CTA
DENSE_MAX_CLUSTER = 8    # CTAs per cluster: the portable limit
# actions the kernels take: the forward's softmax holds 4 per lane, the
# search kernels check the same cap (csrc/dense_forward.cu, search.cu)
MAX_ACTIONS = 128
DENSE_TILES = (16, 32, 48)   # games per tile the kernel takes
DENSE_WARPS = 8
SMEM_LIMIT = 232_448     # dynamic shared memory one CTA may use on sm_90


def dense_smem_bytes(games: int, D: int, kp: int, DV: int, A: int) -> int:
    """Shared memory of one CTA (as ``csrc/dense_forward.cu:layout``): two
    weight stages of 64 rows × max(Kp, D) bf16, the bf16 input rows of the
    tile's games and, where it fits, a second such buffer for fc1's output,
    the CTA's 64 float32 residual columns, the LayerNorm partials of the
    cluster, and the heads' partial sums (from each of the D/64 CTAs, for
    the ⌈games / (D/64)⌉ games this CTA finishes)."""
    cs = D // DENSE_COLS
    lda = max(kp, D) + 8
    stage = DENSE_COLS * lda * 2
    rows = games * lda * 2
    heads = cs * -(-games // cs) * (A + 1) * 4
    rest = (games * (DENSE_COLS + 8) * 4 + cs * games * 8
            + DENSE_WARPS * games * 4 + -(-heads // 16) * 16)
    with_ya = 2 * stage + 2 * rows + rest <= SMEM_LIMIT
    return 2 * stage + (2 if with_ya else 1) * rows + rest


@functools.lru_cache(maxsize=None)
def dense_tiles(D: int, kp: int, DV: int, A: int) -> tuple:
    """The games per tile that fit this network's widths, smallest first.
    Raises ``ValueError`` for widths the kernel does not take."""
    cs = D // DENSE_COLS
    if D % DENSE_COLS or not 1 <= cs <= DENSE_MAX_CLUSTER:
        raise ValueError(f"the dense forward kernel takes widths a multiple "
                         f"of {DENSE_COLS} up to "
                         f"{DENSE_COLS * DENSE_MAX_CLUSTER}, not {D}")
    nv = DV // cs
    if DV % cs or nv % 8 or nv > DENSE_COLS:
        raise ValueError(f"value_fc width {DV} does not split into "
                         f"{cs} slices of a multiple of 8 up to {DENSE_COLS}")
    if kp % 16 or not 1 <= A <= MAX_ACTIONS:
        raise ValueError(f"unsupported widths Kp={kp} A={A}")
    fits = tuple(g for g in DENSE_TILES
                 if dense_smem_bytes(g, D, kp, DV, A) <= SMEM_LIMIT)
    if not fits:
        raise ValueError(f"width {D} needs "
                         f"{dense_smem_bytes(16, D, kp, DV, A)} bytes of "
                         f"shared memory per CTA, over the {SMEM_LIMIT} a "
                         f"CTA may use")
    return fits


def dense_plan(B: int, D: int, kp: int, DV: int, A: int, slots: dict) -> dict:
    """Launch geometry of ``az_dense_forward``: a cluster of D/64 CTAs per
    tile of games, each CTA 64 output columns of every layer.  ``slots``
    maps games per tile to the clusters of that shape the card holds at
    once; the plan takes the smallest tile whose clusters all fit in one
    wave, else the largest (the fewest waves).  Raises ``ValueError`` for
    widths the kernel does not take."""
    if B < 1:
        raise ValueError(f"batch {B} < 1")
    fits = dense_tiles(D, kp, DV, A)
    games = next((g for g in fits if -(-B // g) <= slots[g]), fits[-1])
    tiles = -(-B // games)
    cs = D // DENSE_COLS
    return {"games_per_tile": games, "cluster": cs, "tiles": tiles,
            "ctas": tiles * cs,
            "smem_bytes": dense_smem_bytes(games, D, kp, DV, A),
            "waves": -(-tiles // slots[games])}


K_DENSE = CudaKernel("dense_forward.cu", "az_dense_forward", [
    _P, _I, _I, _I,              # obs, B, FRC, RC
    _P, _I, _I,                  # lines, L, win_len
    _P, _P, _I,                  # stem_w, stem_b, Kp
    _P, _P, _P, _P, _P, _P, _I,  # ln_s, ln_b, w1, b1, w2, b2, nblocks
    _P, _P,                      # fln_s, fln_b
    _P, _P, _I,                  # pol_w, pol_b, A
    _P, _P, _I,                  # vfc_w, vfc_b, DV
    _P, _P, _I,                  # vh_w, vh_b, D
    _P, _P, _I, _P])             # probs, value, games per tile, stream


def _dense_widths(packed: dict):
    D, kp = packed["stem_w"].shape
    return D, kp, packed["vfc_w"].shape[0], packed["pol_w"].shape[0]


@functools.lru_cache(maxsize=None)
def dense_slots(D: int, kp: int, DV: int, A: int) -> dict:
    """Games per tile → how many clusters of that shape the card holds at
    once, as the kernel reports it (``cudaOccupancyMaxActiveClusters``;
    needs CUDA).  Raises if the card holds none."""
    lib = load_lib("dense_forward.cu")
    lib.az_dense_geometry.argtypes = [_I] * 5 + [_P]
    slots = {}
    for games in dense_tiles(D, kp, DV, A):
        out = (ctypes.c_int * 3)()
        rc = lib.az_dense_geometry(games, D, kp, DV, A, ctypes.addressof(out))
        if rc != 0:
            raise RuntimeError(f"az_dense_geometry: CUDA error {rc} "
                               f"({lib.az_error_string(rc).decode()})")
        if (out[0], out[1]) != (dense_smem_bytes(games, D, kp, DV, A),
                                D // DENSE_COLS):
            raise RuntimeError(f"dense geometry: the kernel reports "
                               f"{list(out[:2])} at {games} games per tile")
        if out[2] < 1:
            raise RuntimeError(f"the card holds no cluster of {D // 64} "
                               f"CTAs with {out[0]} bytes of shared memory")
        slots[games] = out[2]
    return slots


def dense_geometry(B: int, packed: dict) -> dict:
    """The launch geometry :func:`dense_forward` uses at batch ``B`` on
    this card, with the clusters it holds at once (needs CUDA)."""
    widths = _dense_widths(packed)
    slots = dense_slots(*widths)
    plan = dense_plan(B, *widths, slots)
    return dict(plan, max_active_clusters=slots[plan["games_per_tile"]])


def dense_forward(obs: torch.Tensor, packed: dict):
    """The in-search dense forward: ``az_dense_forward`` for CUDA tensors,
    :func:`dense_forward_reference` for CPU tensors."""
    if plain(obs):
        return dense_forward_reference(obs, packed)
    dev = obs.device
    B, FRC = obs.shape
    D, kp, DV, A = _dense_widths(packed)
    nb = packed["w1"].shape[0]
    L, K = packed["lines"].shape
    games = dense_plan(B, D, kp, DV, A,
                       dense_slots(D, kp, DV, A))["games_per_tile"]
    bf, f = torch.bfloat16, torch.float32
    check(obs, f, (B, FRC), dev, "obs")
    for name, dt, shape in (
            ("stem_w", bf, (D, kp)), ("stem_b", f, (D,)),
            ("ln_s", f, (nb, D)), ("ln_b", f, (nb, D)),
            ("w1", bf, (nb, D, D)), ("b1", f, (nb, D)),
            ("w2", bf, (nb, D, D)), ("b2", f, (nb, D)),
            ("fln_s", f, (D,)), ("fln_b", f, (D,)),
            ("pol_w", f, (A, D)), ("pol_b", f, (A,)),
            ("vfc_w", bf, (DV, D)), ("vfc_b", f, (DV,)),
            ("vh_w", f, (DV,)), ("vh_b", f, (1,)),
            ("lines", torch.int32, (L, K))):
        check(packed[name], dt, shape, dev, name)
    probs = torch.empty((B, A), dtype=f, device=dev)
    value = torch.empty((B,), dtype=f, device=dev)
    p = packed
    K_DENSE(obs.data_ptr(), B, FRC, p["rc"],
            p["lines"].data_ptr(), L, K,
            p["stem_w"].data_ptr(), p["stem_b"].data_ptr(), kp,
            p["ln_s"].data_ptr(), p["ln_b"].data_ptr(), p["w1"].data_ptr(),
            p["b1"].data_ptr(), p["w2"].data_ptr(), p["b2"].data_ptr(), nb,
            p["fln_s"].data_ptr(), p["fln_b"].data_ptr(),
            p["pol_w"].data_ptr(), p["pol_b"].data_ptr(), A,
            p["vfc_w"].data_ptr(), p["vfc_b"].data_ptr(), DV,
            p["vh_w"].data_ptr(), p["vh_b"].data_ptr(), D,
            probs.data_ptr(), value.data_ptr(), games, stream(obs))
    return probs, value


# ---------------------------------------------------------------------------
# search state
# ---------------------------------------------------------------------------

class Tree:
    """Search state of one move for B games (see the module note)."""

    def __init__(self, env, B: int, num_simulations: int, device):
        self.B, self.A = B, env.action_dim
        self.N = N = num_simulations + 1
        self.dcap = dcap = int(min(env.max_moves + 1, num_simulations + 1))
        self.obs_dim = obs_dim = env.feature_dim * env.rows * env.cols
        A = self.A
        z = dict(device=device)
        self.visit = torch.zeros((B, N), dtype=torch.float32, **z)
        self.val = torch.zeros((B, N), dtype=torch.float32, **z)
        self.child = torch.full((B, N, A), ILLEGAL, dtype=torch.int32, **z)
        self.prior = torch.zeros((B, N, A), dtype=torch.float32, **z)
        self.path = torch.zeros((B, dcap), dtype=torch.int32, **z)
        self.apath = torch.zeros((B, dcap), dtype=torch.int32, **z)
        # the pending leaf of the current simulation
        self.pend = torch.zeros((B, PEND_COLS), dtype=torch.int32, **z)
        self.valid = torch.zeros((B, A), dtype=torch.bool, **z)
        self.obs = torch.zeros((B, obs_dim), dtype=torch.float32, **z)
        # cells of the game's lines, for the kernels' win checks
        self.lines = torch.as_tensor(env.lines, dtype=torch.int32, **z)

    def clone(self) -> "Tree":
        out = Tree.__new__(Tree)
        out.__dict__ = {k: (v.clone() if torch.is_tensor(v) else v)
                        for k, v in self.__dict__.items()}
        return out

    def check(self, device):
        B, N, A, dcap = self.B, self.N, self.A, self.dcap
        for name, dt, shape in (
                ("visit", torch.float32, (B, N)), ("val", torch.float32, (B, N)),
                ("child", torch.int32, (B, N, A)),
                ("prior", torch.float32, (B, N, A)),
                ("path", torch.int32, (B, dcap)),
                ("apath", torch.int32, (B, dcap)),
                ("pend", torch.int32, (B, PEND_COLS)),
                ("valid", torch.bool, (B, A)),
                ("obs", torch.float32, (B, self.obs_dim)),
                ("lines", torch.int32, tuple(self.lines.shape))):
            check(getattr(self, name), dt, shape, device, f"tree.{name}")


def _heights(board: torch.Tensor) -> torch.Tensor:
    """Stones per column ``(B, C)`` int64 of ``(B, 2, R, C)`` boards."""
    return (board[:, 0].long() + board[:, 1].long()).sum(dim=1)


# ---------------------------------------------------------------------------
# plain versions of the search kernels
# ---------------------------------------------------------------------------

def root_obs_reference(env, board, player, rec_obs_m):
    """Canonical root observation ``(B, F·RC)`` float32; writes its int8
    copy into the move's record ``rec_obs_m (B, F, R, C)``."""
    obs = env.observation_from_board(board, player).reshape(board.shape[0], -1)
    rec_obs_m.copy_(obs.to(torch.int8).reshape(rec_obs_m.shape))
    return obs


def root_init_reference(env, cfg: MCTSConfig, tree: Tree, probs, value,
                        noise_m, board):
    """Tree init of one move: Dirichlet mix ``(1-eps)·p + eps·noise`` (when
    ``noise_m (A, B)`` is given), legal mask, root edges with quantized
    priors, root visit 1.5 (one visit, expanded) and ``val = -value``."""
    p = probs
    if noise_m is not None:
        eps = torch.tensor(cfg.dirichlet_eps, dtype=torch.float32)
        one_m = (1.0 - eps).item()
        p = one_m * p + eps.item() * noise_m.T
    valid = (_heights(board) < env.rows if env.rules == RULES_GRAVITY
             else env.valid_mask_board(board, None))
    tree.visit.zero_()
    tree.val.zero_()
    tree.visit[:, 0] = 1.5
    tree.val[:, 0] = -value
    tree.child[:, 0] = torch.where(valid, NO_CHILD, ILLEGAL).to(torch.int32)
    tree.prior[:, 0] = torch.where(valid, qprior(p), torch.zeros_like(p))


def descend_leaf_reference(env, cfg: MCTSConfig, tree: Tree, board, player,
                           mc, slot: int):
    """One simulation's PUCT walk from the root and its leaf.

    Writes ``tree.path``/``apath`` (rows past the walk hold N and 0), the
    pending record ``tree.pend`` (depth, parent, action, alloc, leaf,
    terminal, won), the leaf's legal mask ``tree.valid`` and its canonical
    observation ``tree.obs``, the forward's input.
    """
    B, N, A, dcap = tree.B, tree.N, tree.A, tree.dcap
    R, C = env.rows, env.cols
    dev = board.device
    ar = torch.arange(B, device=dev)
    visit, val = tree.visit, tree.val
    tree.path.fill_(N)
    tree.apath.zero_()
    node = torch.zeros(B, dtype=torch.long, device=dev)
    pv = torch.floor(visit[:, 0])
    stop = visit[:, 0] == pv                      # root not expanded
    depth = torch.zeros(B, dtype=torch.long, device=dev)
    parent = torch.full((B,), -1, dtype=torch.long, device=dev)
    action = torch.zeros(B, dtype=torch.long, device=dev)
    chsel = torch.zeros(B, dtype=torch.long, device=dev)
    flat = board.reshape(B, 2, R * C).clone()
    gravity = env.rules == RULES_GRAVITY
    heights = _heights(board) if gravity else None
    c_puct = torch.tensor(cfg.c_puct, dtype=torch.float32).item()
    for d in range(dcap):
        if bool(stop.all()):
            break
        ch = tree.child[ar, node].long()                       # (B, A)
        pr = tree.prior[ar, node]
        has = ch >= 0
        chc = ch.clamp(min=0)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        cv = torch.where(has, visit[ar[:, None], chc], zero)
        cl = torch.where(has, val[ar[:, None], chc], zero)
        cf = torch.floor(cv)
        ce = (cv - cf) * 2.0
        q = torch.where(cf > 0, cl / torch.clamp(cf, min=1.0), zero)
        explore = pr * (torch.sqrt(pv)[:, None] / (cf + 1.0))
        if cfg.formula == "alphazero":
            explore = c_puct * explore
        ucb = torch.where(ch == ILLEGAL, torch.full_like(q, NEG), q + explore)
        act = first_argmax(ucb)
        c_sel = ch[ar, act]
        v_sel = cf[ar, act]
        e_sel = ce[ar, act]
        now_stop = (c_sel < 0) | (e_sel == 0)
        live = ~stop
        tree.path[live, d] = node[live].to(torch.int32)
        tree.apath[live, d] = act[live].to(torch.int32)
        parent = torch.where(live, node, parent)
        action = torch.where(live, act, action)
        chsel = torch.where(live, c_sel, chsel)
        depth = torch.where(live, torch.full_like(depth, d + 1), depth)
        node = torch.where(live & ~now_stop, c_sel, node)
        pv = torch.where(live, v_sel, pv)
        # play the selected move on the walk's board
        mover = (player.long() + d) % 2
        if gravity:
            h = heights[ar, act]
            put = live & (h < R)
            cell = (R - 1 - h) * C + act
            heights[ar[live], act[live]] += 1
        else:
            put, cell = live, act
        flat[ar[put], mover[put], cell[put]] = 1
        stop = stop | now_stop
    root_case = parent < 0
    alloc = (parent >= 0) & (chsel < 0)
    leaf_player = (player.long() + depth) % 2
    leaf_mc = mc.long() + depth
    won = env.won_batch(flat[ar, 1 - leaf_player].reshape(B, R, C))
    terminal = root_case | won | (leaf_mc >= env.max_moves)
    leaf = torch.where(root_case, torch.zeros_like(chsel),
                       torch.where(alloc, torch.full_like(chsel, slot), chsel))
    cols = (depth, parent, action, alloc, leaf, terminal, won)
    tree.pend.copy_(torch.stack([c.to(torch.int32) for c in cols], dim=1))
    tree.valid.copy_(heights < R if gravity
                     else env.valid_mask_board(flat.reshape(B, 2, R, C),
                                           None))
    tree.obs.copy_(env.observation_from_board(flat.reshape(B, 2, R, C),
                                              leaf_player).reshape(B, -1))


def apply_reference(tree: Tree, slot: int, probs, value):
    """Expansion into slot ``slot`` and backup along the pending path.

    The leaf ply adds 1.5 to ``visit`` when the leaf was expanded (1 visit
    plus the expanded flag), every other ply 1; ``val`` gains
    ``±leaf_value`` with sign +1 where ``depth - d`` is even, and
    ``leaf_value`` is the terminal score (1 for a win of the mover, 0 for a
    draw) or ``-value``.
    """
    B, N, A, dcap = tree.B, tree.N, tree.A, tree.dcap
    dev = probs.device
    ar = torch.arange(B, device=dev)
    pend = tree.pend.long()
    depth, parent, action = pend[:, P_DEPTH], pend[:, P_PARENT], pend[:, P_ACTION]
    alloc = pend[:, P_ALLOC] > 0
    leaf = pend[:, P_LEAF]
    terminal = pend[:, P_TERMINAL] > 0
    won = pend[:, P_WON] > 0
    do_expand = alloc & ~terminal
    e = do_expand[:, None] & tree.valid
    tree.child[:, slot] = torch.where(e, NO_CHILD, ILLEGAL).to(torch.int32)
    tree.prior[:, slot] = torch.where(e, qprior(probs), torch.zeros_like(probs))
    tree.child[ar[alloc], parent[alloc], action[alloc]] = slot
    leaf_value = torch.where(terminal, won.to(torch.float32), -value)
    for d in range(int(depth.max()) + 1):
        m = d <= depth
        nd = torch.where(depth == d, leaf, tree.path[:, min(d, dcap - 1)].long())
        inc = torch.where((depth == d) & do_expand, 1.5, 1.0)
        sv = torch.where((depth - d) % 2 == 0, leaf_value, -leaf_value)
        tree.visit[ar[m], nd[m]] += inc[m]
        tree.val[ar[m], nd[m]] += sv[m]


def move_tail_reference(env, cfg: MCTSConfig, tree: Tree, u, board, player,
                        mc, rec, rec_obs_next=None):
    """Root visit counts and root Q, the action, the env step, the move's
    records and the reset of finished games (``board``/``player``/``mc``
    updated in place).  ``rec`` maps record names to this move's slices.
    With ``rec_obs_next (B, F, R, C)`` (the next move's record) it returns
    :func:`root_obs_reference` of the board and player after the move, else
    None (the chunk's last move)."""
    B, A = tree.B, tree.A
    R, C = env.rows, env.cols
    dev = board.device
    ar = torch.arange(B, device=dev)
    ch0 = tree.child[:, 0].long()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    counts = torch.where(ch0 >= 0,
                         torch.floor(tree.visit[ar[:, None], ch0.clamp(min=0)]),
                         zero)
    root_q = tree.val[:, 0] / torch.clamp(torch.floor(tree.visit[:, 0]), min=1.0)
    total = torch.clamp(counts.sum(-1, keepdim=True), min=1.0)
    policy = counts / total
    greedy = first_argmax(counts)
    acc = torch.zeros(B, dtype=torch.float32, device=dev)
    cum = []
    for a in range(A):                       # sequential float32 sum
        acc = acc + policy[:, a]
        cum.append(acc)
    above = torch.stack(cum, dim=1) > u[:, None]
    sampled = torch.where(above.any(-1), above.to(torch.int8).argmax(-1),
                          torch.full_like(greedy, A))
    ids = torch.arange(A, device=dev)
    last_visited = torch.where(counts > 0, ids, -1).max(dim=-1).values
    fallback = torch.where(last_visited >= 0, last_visited, greedy)
    sampled = torch.where(sampled >= A, fallback, sampled)
    act = torch.where(mc < cfg.temperature_moves, sampled, greedy)
    # env step
    flat = board.reshape(B, 2, R * C)
    pl = player.long()
    if env.rules == RULES_GRAVITY:
        h = _heights(board)[ar, act]
        put = h < R
        flat[ar[put], pl[put], ((R - 1 - h) * C + act)[put]] = 1
    else:
        flat[ar, pl, act] = 1
    won = env.won_batch(board[ar, pl])
    mc1 = mc + 1
    done = won | (mc1 >= env.max_moves)
    rec["policy"].copy_(policy)
    rec["player"].copy_(player)
    rec["t"].copy_(mc)
    rec["action"].copy_(act.to(torch.int32))
    rec["done"].copy_(done)
    rec["winner"].copy_(torch.where(won, player, torch.full_like(player, -1)))
    rec["root_q"].copy_(root_q)
    board[done] = 0
    player.copy_(torch.where(done, torch.zeros_like(player), 1 - player))
    mc.copy_(torch.where(done, torch.zeros_like(mc), mc1))
    if rec_obs_next is None:
        return None
    return root_obs_reference(env, board, player, rec_obs_next)


def move_root_init_reference(tree: Tree, root_prior, value, live):
    """Tree init of the move search from the host's root: ``root_prior (B,
    A)`` (``NEG`` where an action is illegal or the game finished), the root
    ``value (B,)`` and ``live (B,)`` bool.  Root visit ``1 + 0.5·live`` (a
    finished game's root stays unexpanded), ``val = -value`` for live games
    and 0 otherwise; an edge is legal iff its prior is > -1e29 and then holds
    the quantized prior."""
    ok = root_prior > -1e29
    zero = torch.zeros_like(value)
    tree.visit.zero_()
    tree.val.zero_()
    tree.visit[:, 0] = torch.where(live, zero + 1.5, zero + 1.0)
    tree.val[:, 0] = torch.where(live, -value, zero)
    tree.child[:, 0] = torch.where(ok, NO_CHILD, ILLEGAL).to(torch.int32)
    tree.prior[:, 0] = torch.where(ok, qprior(root_prior),
                                   torch.zeros_like(root_prior))


def root_counts_reference(tree: Tree):
    """Root visit counts ``(B, A)`` int32, the policy ``counts / max(Σ, 1)``
    and root Q ``val[0] / max(floor(visit[0]), 1)``."""
    B = tree.B
    ar = torch.arange(B, device=tree.visit.device)
    ch0 = tree.child[:, 0].long()
    zero = torch.zeros((), dtype=torch.float32, device=tree.visit.device)
    counts = torch.where(ch0 >= 0,
                         torch.floor(tree.visit[ar[:, None], ch0.clamp(min=0)]),
                         zero).to(torch.int32)
    total = torch.clamp(counts.sum(-1), min=1).to(torch.float32)
    policy = counts.to(torch.float32) / total[:, None]
    root_q = tree.val[:, 0] / torch.clamp(torch.floor(tree.visit[:, 0]),
                                          min=1.0)
    return counts, policy, root_q


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def search_group(A: int) -> int:
    """Lanes per game of the group kernels (``az_root_init``,
    ``az_descend_leaf``, ``az_apply``, ``az_move_tail``,
    ``az_root_counts``) for A actions
    (``csrc/search.cu:group_size``): the smallest of 8, 16 and 32 that holds
    A, and 32 above that (a warp; each lane then reads up to 4 edges)."""
    if not 1 <= A <= MAX_ACTIONS:
        raise ValueError(f"the search kernels take 1 to {MAX_ACTIONS} "
                         f"actions, not {A}")
    return 8 if A <= 8 else 16 if A <= 16 else 32


def search_geometry(B: int, A: int) -> dict:
    """Launch geometry of the group kernels (:func:`search_group`) at B
    games of A actions: a group of G lanes per game, ``SEARCH_THREADS // G``
    games per CTA, as many CTAs as the games need."""
    if B < 1:
        raise ValueError(f"batch {B} < 1")
    G = search_group(A)
    games = SEARCH_THREADS // G
    return {"lanes_per_game": G, "games_per_cta": games,
            "ctas": -(-B // games), "threads_per_cta": SEARCH_THREADS}


def search_kernel_geometry(B: int, A: int) -> dict:
    """:func:`search_geometry` as the kernels' library reports it
    (``az_search_geometry``; needs the CUDA toolkit).  Raises if the two
    disagree."""
    lib = load_lib("search.cu")
    lib.az_search_geometry.argtypes = [_I, _I, _P]
    out = (ctypes.c_int * 4)()
    rc = lib.az_search_geometry(B, A, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"az_search_geometry: CUDA error {rc} "
                           f"({lib.az_error_string(rc).decode()})")
    got = dict(zip(("lanes_per_game", "games_per_cta", "ctas",
                    "threads_per_cta"), out))
    if got != search_geometry(B, A):
        raise RuntimeError(f"search geometry: the kernels report {got}, "
                           f"search_geometry gives {search_geometry(B, A)}")
    return got


K_ROOT_OBS = CudaKernel("search.cu", "az_root_obs", [
    _P, _P, _P, _P, _I, _I, _I, _P])
K_ROOT_INIT = CudaKernel("search.cu", "az_root_init", [
    _P, _P, _P, _P, _P, _P, _P, _P,       # visit val child prior probs value noise board
    _I, _I, _I, _I, _I, _I, _F, _P])      # B N A R C rules eps stream
K_DESCEND = CudaKernel("search.cu", "az_descend_leaf", [
    _P, _P, _P, _P, _P, _P, _P, _P,       # visit val child prior board player mc lines
    _P, _P, _P, _P, _P,                   # path apath pend valid obs
    _I, _I, _I, _I, _I, _I, _I, _I, _I,   # B N A R C F L K dcap
    _I, _I, _I, _I, _F, _P])              # max_moves rules slot az c_puct stream
K_APPLY = CudaKernel("search.cu", "az_apply", [
    _P, _P, _P, _P, _P, _P, _P, _P, _P,   # visit val child prior path pend valid probs value
    _I, _I, _I, _I, _I, _P])              # B N A dcap slot stream
K_TAIL = CudaKernel("search.cu", "az_move_tail", [
    _P, _P, _P, _P, _P, _P, _P, _P,       # visit val child unif board player mc lines
    _P, _P, _P, _P, _P, _P, _P,           # rec policy player t action done winner root_q
    _P, _P,                               # obs_next rec_obs_next
    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # B N A R C F L K max_moves rules temp
    _P])                                  # stream
K_MOVE_ROOT_INIT = CudaKernel("search.cu", "az_move_root_init", [
    _P, _P, _P, _P, _P, _P, _P,           # visit val child prior root_prior value live
    _I, _I, _I, _P])                      # B N A stream
K_ROOT_COUNTS = CudaKernel("search.cu", "az_root_counts", [
    _P, _P, _P, _P, _P, _P,               # visit val child counts policy root_q
    _I, _I, _I, _P])                      # B N A stream

KERNELS = [K_DENSE, K_ROOT_OBS, K_ROOT_INIT, K_DESCEND, K_APPLY, K_TAIL,
           K_MOVE_ROOT_INIT, K_ROOT_COUNTS]


def _board_check(env, board, player, mc, dev):
    B = board.shape[0]
    check(board, torch.int8, (B, 2, env.rows, env.cols), dev, "board")
    check(player, torch.int32, (B,), dev, "player")
    if mc is not None:
        check(mc, torch.int32, (B,), dev, "mc")


def root_obs(env, board, player, rec_obs_m):
    """``az_root_obs`` for CUDA tensors, :func:`root_obs_reference` for CPU tensors."""
    if plain(board):
        return root_obs_reference(env, board, player, rec_obs_m)
    dev = board.device
    B = board.shape[0]
    RC = env.rows * env.cols
    F = env.feature_dim
    _board_check(env, board, player, None, dev)
    check(rec_obs_m, torch.int8, (B, F, env.rows, env.cols), dev, "rec_obs")
    obs = torch.empty((B, F * RC), dtype=torch.float32, device=dev)
    K_ROOT_OBS(board.data_ptr(), player.data_ptr(), obs.data_ptr(),
               rec_obs_m.data_ptr(), B, RC, F, stream(board))
    return obs


def root_init(env, cfg: MCTSConfig, tree: Tree, probs, value, noise_m, board):
    """``az_root_init`` for CUDA tensors, :func:`root_init_reference` for CPU tensors."""
    if plain(board):
        return root_init_reference(env, cfg, tree, probs, value, noise_m,
                                   board)
    dev = board.device
    B, N, A = tree.B, tree.N, tree.A
    tree.check(dev)
    check(probs, torch.float32, (B, A), dev, "probs")
    check(value, torch.float32, (B,), dev, "value")
    check(board, torch.int8, (B, 2, env.rows, env.cols), dev, "board")
    if noise_m is not None:
        check(noise_m, torch.float32, (A, B), dev, "noise")
    K_ROOT_INIT(tree.visit.data_ptr(), tree.val.data_ptr(),
                tree.child.data_ptr(), tree.prior.data_ptr(),
                probs.data_ptr(), value.data_ptr(),
                None if noise_m is None else noise_m.data_ptr(),
                board.data_ptr(), B, N, A, env.rows, env.cols, env.rules,
                float(cfg.dirichlet_eps), stream(board))


def descend_leaf(env, cfg: MCTSConfig, tree: Tree, board, player, mc,
                 slot: int):
    """``az_descend_leaf`` for CUDA tensors, :func:`descend_leaf_reference` for CPU tensors."""
    if plain(board):
        return descend_leaf_reference(env, cfg, tree, board, player, mc, slot)
    dev = board.device
    B, N, A, dcap = tree.B, tree.N, tree.A, tree.dcap
    tree.check(dev)
    _board_check(env, board, player, mc, dev)
    L, K = tree.lines.shape
    K_DESCEND(tree.visit.data_ptr(), tree.val.data_ptr(),
              tree.child.data_ptr(), tree.prior.data_ptr(),
              board.data_ptr(), player.data_ptr(), mc.data_ptr(),
              tree.lines.data_ptr(), tree.path.data_ptr(),
              tree.apath.data_ptr(), tree.pend.data_ptr(),
              tree.valid.data_ptr(), tree.obs.data_ptr(),
              B, N, A, env.rows, env.cols, env.feature_dim, L, K, dcap,
              env.max_moves, env.rules, int(slot), int(cfg.formula == "alphazero"), float(cfg.c_puct),
              stream(board))


def apply(tree: Tree, slot: int, probs, value):
    """``az_apply`` for CUDA tensors, :func:`apply_reference` for CPU tensors."""
    if plain(probs):
        return apply_reference(tree, slot, probs, value)
    dev = probs.device
    B, N, A, dcap = tree.B, tree.N, tree.A, tree.dcap
    tree.check(dev)
    check(probs, torch.float32, (B, A), dev, "probs")
    check(value, torch.float32, (B,), dev, "value")
    K_APPLY(tree.visit.data_ptr(), tree.val.data_ptr(),
            tree.child.data_ptr(), tree.prior.data_ptr(),
            tree.path.data_ptr(), tree.pend.data_ptr(), tree.valid.data_ptr(),
            probs.data_ptr(), value.data_ptr(), B, N, A, dcap, int(slot),
            stream(probs))


_REC_TYPES = {"policy": torch.float32, "player": torch.int32,
              "t": torch.int32, "action": torch.int32, "done": torch.bool,
              "winner": torch.int32, "root_q": torch.float32}


def move_tail(env, cfg: MCTSConfig, tree: Tree, u, board, player, mc, rec,
              rec_obs_next=None):
    """``az_move_tail`` for CUDA tensors, :func:`move_tail_reference` for
    CPU tensors.  The next root's observation is a new tensor each call."""
    if plain(board):
        return move_tail_reference(env, cfg, tree, u, board, player, mc, rec,
                                   rec_obs_next)
    dev = board.device
    B, N, A = tree.B, tree.N, tree.A
    R, C, F = env.rows, env.cols, env.feature_dim
    tree.check(dev)
    check(u, torch.float32, (B,), dev, "unif")
    _board_check(env, board, player, mc, dev)
    for name, dt in _REC_TYPES.items():
        check(rec[name], dt, (B, A) if name == "policy" else (B,), dev,
               f"rec.{name}")
    obs = None
    if rec_obs_next is not None:
        check(rec_obs_next, torch.int8, (B, F, R, C), dev, "rec_obs_next")
        obs = torch.empty((B, F * R * C), dtype=torch.float32, device=dev)
    L, K = tree.lines.shape
    K_TAIL(tree.visit.data_ptr(), tree.val.data_ptr(), tree.child.data_ptr(),
           u.data_ptr(), board.data_ptr(), player.data_ptr(), mc.data_ptr(),
           tree.lines.data_ptr(),
           *(rec[name].data_ptr() for name in _REC_TYPES),
           None if obs is None else obs.data_ptr(),
           None if obs is None else rec_obs_next.data_ptr(),
           B, N, A, R, C, F, L, K, env.max_moves, env.rules,
           int(cfg.temperature_moves), stream(board))
    return obs


def move_root_init(tree: Tree, root_prior, value, live):
    """``az_move_root_init`` for CUDA tensors,
    :func:`move_root_init_reference` for CPU tensors."""
    if plain(root_prior):
        return move_root_init_reference(tree, root_prior, value, live)
    dev = root_prior.device
    B, N, A = tree.B, tree.N, tree.A
    tree.check(dev)
    check(root_prior, torch.float32, (B, A), dev, "root_prior")
    check(value, torch.float32, (B,), dev, "value")
    check(live, torch.bool, (B,), dev, "live")
    K_MOVE_ROOT_INIT(tree.visit.data_ptr(), tree.val.data_ptr(),
                     tree.child.data_ptr(), tree.prior.data_ptr(),
                     root_prior.data_ptr(), value.data_ptr(), live.data_ptr(),
                     B, N, A, stream(root_prior))


def root_counts(tree: Tree):
    """``az_root_counts`` for CUDA tensors, :func:`root_counts_reference`
    for CPU tensors."""
    if plain(tree.visit):
        return root_counts_reference(tree)
    dev = tree.visit.device
    B, N, A = tree.B, tree.N, tree.A
    tree.check(dev)
    counts = torch.empty((B, A), dtype=torch.int32, device=dev)
    policy = torch.empty((B, A), dtype=torch.float32, device=dev)
    root_q = torch.empty((B,), dtype=torch.float32, device=dev)
    K_ROOT_COUNTS(tree.visit.data_ptr(), tree.val.data_ptr(),
                  tree.child.data_ptr(), counts.data_ptr(), policy.data_ptr(),
                  root_q.data_ptr(), B, N, A, stream(tree.visit))
    return counts, policy, root_q


PLAIN = SimpleNamespace(root_obs=root_obs_reference,
                        root_init=root_init_reference,
                        descend_leaf=descend_leaf_reference,
                        apply=apply_reference,
                        move_tail=move_tail_reference,
                        move_root_init=move_root_init_reference,
                        root_counts=root_counts_reference)
DISPATCH = SimpleNamespace(root_obs=root_obs,
                           root_init=root_init, descend_leaf=descend_leaf,
                           apply=apply, move_tail=move_tail,
                           move_root_init=move_root_init,
                           root_counts=root_counts)


# ---------------------------------------------------------------------------
# the chunk
# ---------------------------------------------------------------------------

def supports_chunk(env, model, cfg: MCTSConfig) -> bool:
    """Whether the dense tower's searches of this module (the whole-chunk
    self-play and the move search) serve ``env``, ``model`` and ``cfg``;
    the JAX package's ``supports_selfplay_fused`` / ``supports_fused``.

    Its semantic gates: a ``DenseTower``, sequential simulations
    (``leaf_batch == 1``) and ``num_simulations + 2 < 512`` (the bound of
    the packed edges, whose priors are quantized).  The capacity gate of the
    port: the search kernels take the game's board and actions and the
    forward kernel the tower's widths (:func:`dense_tiles`).  It reads no
    device, so the CPU and the card choose the same engine; what it
    refuses runs move by move on the per-simulation engine."""
    if not (isinstance(model, DenseTower) and cfg.leaf_batch == 1
            and cfg.num_simulations + 2 < 512):
        return False
    if env.rows * env.cols > SEARCH_MAX_CELLS or (
            env.rules == RULES_GRAVITY and env.cols > SEARCH_MAX_COLS):
        return False
    try:
        dense_tiles(model.width, _pad16(model.in_features), model.width // 4,
                    env.action_dim)
    except ValueError:
        return False
    return True


def _simulate(ops, env, cfg: MCTSConfig, tree: Tree, board, player, mc,
              evaluator):
    """Simulations 1..S-1 of one move's search, the chunk's and the move
    search's: a fixed chain of launches that never reads the device."""
    for slot in range(1, cfg.num_simulations):
        ops.descend_leaf(env, cfg, tree, board, player, mc, slot)
        probs, value = evaluator(tree.obs)
        ops.apply(tree, slot, probs, value)


def _sims(ops, env, cfg: MCTSConfig, tree: Tree, board, player, mc,
          evaluator, entry, restart):
    """Simulations 1..S-1 of one move, a ``search.sims`` span: the eager
    chain without an ``entry`` of :data:`MOVE_GRAPHS`, else the entry's
    graph (a ``search.graph`` span), captured at the entry's first use.
    The capture's warm-up runs the chain on the entry's tree, so
    ``restart()`` then initialises its root again."""
    with span("search.sims", cfg.num_simulations - 1):
        if entry is None:
            _simulate(ops, env, cfg, tree, board, player, mc, evaluator)
            return
        if entry.replay is None:
            entry.replay = MOVE_GRAPHS.capture(functools.partial(
                _simulate, ops, env, cfg, entry.tree, entry.board,
                entry.player, entry.mc, entry.forward), entry.board.device)
            restart()
        MOVE_GRAPHS.replays += 1
        with span("search.graph"):
            entry.replay()


def _chunk(ops, env, cfg: MCTSConfig, boards, players, move_counts, M: int,
           noise, unif, evaluator, packed=None):
    B = boards.shape[0]
    A, F = env.action_dim, env.feature_dim
    R, C = env.rows, env.cols
    dev = boards.device
    S = cfg.num_simulations
    with span("search.prepare"):
        board = boards.to(torch.int8).contiguous()
        player = players.to(torch.int32).contiguous()
        mc = move_counts.to(torch.int32).contiguous()
        entry = (None if packed is None
                 else MOVE_GRAPHS.entry(env, cfg, board, player, mc, packed))
        if entry is None:
            board, player, mc = board.clone(), player.clone(), mc.clone()
            tree = Tree(env, B, S, dev)
        else:
            board, player, mc, tree = (entry.board, entry.player, entry.mc,
                                       entry.tree)
        rec = {name: torch.zeros((M, B, A) if name == "policy" else (M, B),
                                 dtype=dt, device=dev)
               for name, dt in _REC_TYPES.items()}
        rec_obs = torch.zeros((M, B, F, R, C), dtype=torch.int8, device=dev)
        # the first move's root; each tail writes the next one's
        obs = ops.root_obs(env, board, player, rec_obs[0]) if M else None
    for m in range(M):
        with span("search.move"):
            with span("search.root"):
                probs0, value0 = evaluator(obs)
                root = functools.partial(
                    ops.root_init, env, cfg, tree, probs0, value0,
                    noise[m] if cfg.use_dirichlet else None, board)
                root()
            _sims(ops, env, cfg, tree, board, player, mc, evaluator, entry,
                  root)
            with span("search.finish"):
                obs = ops.move_tail(env, cfg, tree, unif[m], board, player,
                                    mc, {k: v[m] for k, v in rec.items()},
                                    rec_obs[m + 1] if m + 1 < M else None)
    if entry is not None:      # the next search at the key overwrites them
        board, player, mc = board.clone(), player.clone(), mc.clone()
    out = dict(rec)
    out.update(obs=rec_obs, board=board, player_final=player, mc_final=mc)
    return out


def _inputs(env, cfg, boards, players, move_counts, M, generator, noise,
            unif, dev):
    B = boards.shape[0]
    if noise is None and cfg.use_dirichlet:
        noise = dirichlet_noise(M, env.action_dim, B, cfg.dirichlet_alpha,
                                generator, dev)
    if unif is None:
        unif = torch.rand((M, B), generator=generator, device=dev)
    if noise is not None:
        noise = noise.to(dev, torch.float32).contiguous()
    return (boards.to(dev), players.to(dev), move_counts.to(dev), noise,
            unif.to(dev, torch.float32).contiguous())


def selfplay_chunk_reference(env, model, params, boards, players, move_counts,
                             cfg: MCTSConfig, M: int, *, generator=None,
                             noise=None, unif=None, evaluator=None):
    """Plain PyTorch version of the whole chunk, on the inputs' device."""
    dev = boards.device
    boards, players, move_counts, noise, unif = _inputs(
        env, cfg, boards, players, move_counts, M, generator, noise, unif, dev)
    if evaluator is None:
        packed = pack_dense_params(model, params, dev)
        evaluator = lambda obs: dense_forward_reference(obs, packed)  # noqa: E731
    return _chunk(PLAIN, env, cfg, boards, players, move_counts, M, noise,
                  unif, evaluator)


def run_selfplay_chunk(env, model, params, boards, players, move_counts,
                       cfg: MCTSConfig, M: int, *, generator=None, noise=None,
                       unif=None, evaluator=None, device="cuda"):
    """Run M self-play moves for all B games.

    Inputs are raw states (``boards (B, 2, R, C)`` int8, ``players`` and
    ``move_counts (B,)``), all games live.  ``noise (M, A, B)`` and
    ``unif (M, B)`` are drawn from ``generator`` unless given;
    ``evaluator(obs (B, F·RC)) → (probs (B, A), value (B,))`` replaces the
    dense forward (tests pass exact stubs).  Returns the move-major records
    of the JAX package's ``run_selfplay_chunk_fused``::

      obs (M, B, F, R, C) int8, policy (M, B, A) f32, player / t / action /
      winner (M, B) int32, done (M, B) bool, root_q (M, B) f32,
      board / player_final / mc_final  the state after M moves

    On CUDA every stage runs as a CUDA kernel; on the CPU the wrappers run
    the plain versions.  Without an ``evaluator`` the simulations on CUDA go
    through :data:`MOVE_GRAPHS`, whose search shapes the move search
    shares: from a shape's ``CAPTURE_AT``-th call on, every move replays
    one CUDA graph of the same launches.  The returned tensors are fresh.
    """
    with span("search.prepare"):
        dev = resolve_device(device)
        boards, players, move_counts, noise, unif = _inputs(
            env, cfg, boards, players, move_counts, M, generator, noise,
            unif, dev)
        packed = None
        if evaluator is None:
            packed = pack_dense_params(model, params, dev)
            evaluator = lambda obs: dense_forward(obs, packed)  # noqa: E731
    return _chunk(DISPATCH, env, cfg, boards, players, move_counts, M, noise,
                  unif, evaluator, packed=packed)


# ---------------------------------------------------------------------------
# the move search (the arena's and the gate's search)
# ---------------------------------------------------------------------------

class _MoveEntry:
    """The fixed addresses of one key's captured simulations: its tree,
    the board, player and move counts of the search or chunk, the packed
    weights, and the graph's replay (None until captured)."""

    def __init__(self, env, S: int, board, player, mc, packed: dict):
        self.tree = Tree(env, board.shape[0], S, board.device)
        self.board = torch.empty_like(board)
        self.player = torch.empty_like(player)
        self.mc = torch.empty_like(mc)
        self.packed = {k: torch.empty_like(v) if torch.is_tensor(v) else v
                       for k, v in packed.items()}
        self._weights = [k for k, v in packed.items() if torch.is_tensor(v)]
        self.replay = None

    def load(self, board, player, mc, packed: dict):
        """Copy one search's inputs and weights to the fixed addresses (one
        host call for all of them)."""
        torch._foreach_copy_(
            [self.board, self.player, self.mc]
            + [self.packed[k] for k in self._weights],
            [board, player, mc] + [packed[k] for k in self._weights])

    def forward(self, obs):
        return dense_forward(obs, self.packed)


class MoveGraphs(GraphCache):
    """The simulations 1..S-1 of the move search and of the self-play
    chunk replayed as one CUDA graph per search shape.

    A move search or a chunk on CUDA tensors that runs the dense kernel's
    own forward (``run_mcts_fused`` or ``run_selfplay_chunk`` without an
    ``evaluator``) looks up its key once a call: the device, B, S, the
    game's geometry and rules, the formula, ``c_puct`` and the tower's
    widths, all that the captured launches bake in (root noise and the
    temperature act only on the eager root and tail).  A key's
    ``CAPTURE_AT``-th call captures the chain (``ops.graphs.capture``) on
    a tree of the key's own at its first move, and that call and every
    later one at the key copy their board, player, move counts and packed
    weights to the entry's fixed addresses, initialise the root on its
    tree (which resets it: every other row is rewritten before it is read)
    and replay the graph every move, a ``search.graph`` span inside
    ``search.sims``; a chunk's root, root init and tail run eagerly on
    the entry's board between its replays.  Every other call, and every
    call on the CPU, runs the chain eagerly on a fresh tree.  The weights
    are copied on every call, so a swapped or updated params dict is seen.
    At most ``MAX_GRAPHS`` keys are held.  ``captures`` and ``replays``
    count the graphs made and the moves that replayed one.  The process
    has one cache, :data:`MOVE_GRAPHS`, so the calls of every caller at
    one shape (the gate's two players, a game's agent moves, the
    collector's chunks) share an entry and its count of calls."""

    @staticmethod
    def key(env, cfg: MCTSConfig, board, packed: dict) -> tuple:
        # the tree's dcap follows from max_moves and S
        return (board.device, board.shape[0], cfg.num_simulations,
                env.rows, env.cols, env.feature_dim, env.action_dim,
                env.max_moves, env.rules, tuple(env.lines.shape),
                cfg.formula, float(cfg.c_puct), _dense_widths(packed),
                packed["w1"].shape[0], tuple(packed["lines"].shape))

    def entry(self, env, cfg: MCTSConfig, board, player, mc, packed: dict):
        """The key's entry with this call's inputs loaded, or None where
        the call runs eagerly."""
        if not self._engages(board):
            return None
        e = self.lookup(self.key(env, cfg, board, packed),
                        lambda: _MoveEntry(env, cfg.num_simulations, board,
                                           player, mc, packed))
        if e is not None:
            e.load(board, player, mc, packed)
        return e


MOVE_GRAPHS = MoveGraphs()


def _move_tree(ops, env, cfg: MCTSConfig, eval_fn, boards, players,
               move_counts, dones, use_dirichlet, noise, evaluator,
               packed=None) -> Tree:
    """The move search's tree after its root (evaluated on the host) and
    simulations 1..S-1.  With ``packed``, the weights ``evaluator`` runs
    the dense kernel on, the simulations may replay a graph of
    :data:`MOVE_GRAPHS`; the tree is then the graph's, and holds this
    search only until the next one at its key."""
    B = boards.shape[0]
    S = cfg.num_simulations
    with span("search.prepare"):
        board = boards.to(torch.int8).contiguous()
        player = players.to(torch.int32).contiguous()
        mc = move_counts.to(torch.int32).contiguous()
        entry = (None if packed is None
                 else MOVE_GRAPHS.entry(env, cfg, board, player, mc, packed))
        tree = Tree(env, B, S, boards.device) if entry is None else entry.tree
    with span("search.root"):
        prior0, value0, live = root_prior(env, cfg, eval_fn, board, player,
                                          mc, dones, use_dirichlet, noise)
        ops.move_root_init(tree, prior0, value0, live)
    _sims(ops, env, cfg, tree, board, player, mc, evaluator, entry,
          functools.partial(ops.move_root_init, tree, prior0, value0, live))
    return tree


def _move(ops, *args, packed=None):
    tree = _move_tree(ops, *args, packed=packed)
    with span("search.finish"):
        counts, policy, root_q = ops.root_counts(tree)
    return SearchResult(visit_counts=counts, policy=policy, root_q=root_q)


def move_search_reference(env, model, params, eval_fn, boards, players,
                          move_counts, dones, cfg: MCTSConfig, *,
                          generator=None, use_dirichlet=None, noise=None,
                          evaluator=None):
    """Plain PyTorch version of :func:`run_mcts_fused`, on the inputs'
    device."""
    dev = boards.device
    args = search_inputs(env, cfg, boards, players, move_counts, dones,
                         generator, use_dirichlet, noise, dev)
    if evaluator is None:
        packed = pack_dense_params(model, params, dev)
        evaluator = lambda obs: dense_forward_reference(obs, packed)  # noqa: E731
    return _move(PLAIN, env, cfg, eval_fn, *args, evaluator)


def run_mcts_fused(env, model, params, eval_fn, boards, players, move_counts,
                   dones, cfg: MCTSConfig, *, generator=None,
                   use_dirichlet=None, noise=None, evaluator=None,
                   device="cuda"):
    """One move's search for B games; the JAX package's ``run_mcts_fused``
    (its Pallas ``_move_kernel``), with the same returns as ``run_mcts``.

    ``eval_fn(obs (B, F, R, C)) → (probs, value)`` evaluates the root only,
    outside the search (the network module in plain PyTorch).  The root
    prior is mixed with Dirichlet ``noise (B, A)`` (drawn from ``generator``
    unless given) where ``use_dirichlet (B,)`` holds (default
    ``cfg.use_dirichlet``), then masked to ``NEG`` where an action is
    illegal or the game is finished (``dones (B,)``).  Simulations 1..S-1
    run the chunk search's descent, forward and apply kernels
    (``evaluator(obs (B, F·RC))`` replaces the dense forward; tests pass
    exact stubs); a finished game's root is the leaf of every simulation
    and backs up its terminal score, so its counts stay 0.  Returns a
    ``SearchResult`` with ``visit_counts (B, A)`` int32, ``policy`` and
    ``root_q (B,)``.  On CUDA every stage of the search runs as a CUDA
    kernel; on the CPU the wrappers run the plain versions.  Without an
    ``evaluator`` the simulations on CUDA go through :data:`MOVE_GRAPHS`:
    from a shape's ``CAPTURE_AT``-th search on they replay one CUDA graph
    of the same launches.  The returned tensors are fresh.
    """
    with span("search.move"):
        with span("search.prepare"):
            dev = resolve_device(device)
            args = search_inputs(env, cfg, boards, players, move_counts,
                                 dones, generator, use_dirichlet, noise, dev)
            packed = None
            if evaluator is None:
                packed = pack_dense_params(model, params, dev)
                evaluator = lambda obs: dense_forward(obs, packed)  # noqa: E731
        return _move(DISPATCH, env, cfg, eval_fn, *args, evaluator,
                     packed=packed)
