"""The per-simulation search engine: one kernel launch per simulation.

Counterpart of the JAX package's ``search/pallas_mcts.py``
(``run_mcts_pallas`` with its Pallas ``_sim_kernel`` and ``_flush_kernel``),
which serves every network evaluator without ``dense_spec`` (the ResNet of
the ``connect4-resnet`` and ``tictactoe`` presets).  Per move, for all B
games:

  root evaluation + Dirichlet mix + root expansion (host, as in the JAX
  package) → for i = 1..S-1: ``sim_step(i)`` → ``eval_fn(obs)`` → one
  ``flush`` → root counts, policy and root Q.

``sim_step(i)`` first applies simulation i-1's expansion and backup (the
network's output for i-1's leaf arrives between launches), then runs
simulation i: the PUCT descent, the leaf board, the terminal check, the
legal mask and the canonical observation of the leaf.  ``flush`` is the
update alone, for the last simulation.  The first ``sim_step`` has nothing
to flush (previous slot < 1).

The tree is ``search/tree.py``'s, games in rows: ``stats (B, N, 3)``
float32, exact float32 priors ``prior (B, N, A)`` and ``children (B, N, A)``
int32.  The state carried between launches (:class:`SimState`) is the walk
(``path``/``apath (B, dcap)``), the leaf record ``meta (B, 8)`` int32 (depth,
parent, action, alloc, leaf node, terminal, won, leaf player), the leaf's
legal mask ``valid (B, A)`` and its observation ``obs (B, F, R, C)``
float32, the network's input.

Each kernel is hand-written CUDA (``csrc/sim.cu``) with its plain PyTorch
version here, made of the portable engine's own parts (``search/mcts.py``:
:func:`descend`, :func:`leaf_finish`, :func:`expand_backup`), so the engines
agree exactly.  Both kernels give each game a group of G lanes, G from the
action count (:func:`sim_geometry`: 8 at connect4, 16 at tictactoe, 32 at
gomoku, up to 256 actions): the update spreads its row of priors over the
lanes and its backup over the plies, the walk reads a node's edges across
the group and reduces them by shuffles to the serial loop's first maximum,
and the leaf finish spreads the win check, legal mask and observation.  A
wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  The CUDA source is built with
``-fmad=false`` and follows the plain version's float32 operation order:
kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from types import SimpleNamespace

import torch

from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.device import resolve_device
from alphazero_tpu_torch.ops.build import (CudaKernel, check, load, plain,
                                           stream)
from alphazero_tpu_torch.search.mcts import (SearchResult, descend,
                                             expand_backup, expand_root,
                                             leaf_finish, prep_priors,
                                             search_inputs, search_result)
from alphazero_tpu_torch.search.tree import Tree, init_tree
from alphazero_tpu_torch.utils.profiling import span

# columns of the leaf record ``meta``
M_DEPTH, M_PARENT, M_ACTION, M_ALLOC, M_LEAF, M_TERMINAL, M_WON, M_PLAYER = \
    range(8)
META_COLS = 8


@dataclasses.dataclass
class SimState:
    """What one launch hands the next: the walk, the leaf record, the leaf's
    legal mask and its observation; and the game's line cells, for the
    kernel's win check."""

    path: torch.Tensor    # (B, dcap) int32, N past the walk
    apath: torch.Tensor   # (B, dcap) int32
    meta: torch.Tensor    # (B, 8) int32
    valid: torch.Tensor   # (B, A) bool
    obs: torch.Tensor     # (B, F, R, C) float32
    lines: torch.Tensor   # (L, win_len) int32 cells of the game's lines

    @staticmethod
    def create(env, B: int, num_simulations: int, device) -> "SimState":
        N = num_simulations + 1
        dcap = int(min(env.max_moves + 1, N))
        z = dict(device=device)
        return SimState(
            path=torch.full((B, dcap), N, dtype=torch.int32, **z),
            apath=torch.zeros((B, dcap), dtype=torch.int32, **z),
            meta=torch.zeros((B, META_COLS), dtype=torch.int32, **z),
            valid=torch.zeros((B, env.action_dim), dtype=torch.bool, **z),
            obs=torch.zeros((B, env.feature_dim, env.rows, env.cols),
                            dtype=torch.float32, **z),
            lines=torch.as_tensor(env.lines, dtype=torch.int32, **z))

    def clone(self) -> "SimState":
        return SimState(*(getattr(self, f.name).clone()
                          for f in dataclasses.fields(self)))


# ---------------------------------------------------------------------------
# plain versions of the kernels
# ---------------------------------------------------------------------------

def flush_reference(tree: Tree, st: SimState, probs, value, slot: int):
    """Kernel 4: the expansion and backup of the simulation whose leaf is in
    ``st`` and whose network output is ``probs (B, A)``, ``value (B,)``,
    into slot ``slot``; nothing when ``slot < 1``."""
    if slot < 1:
        return
    meta = st.meta.long()
    alloc = meta[:, M_ALLOC] > 0
    terminal = meta[:, M_TERMINAL] > 0
    dt = tree.stats.dtype
    leaf_value = torch.where(terminal, (meta[:, M_WON] > 0).to(dt),
                             (-value).to(dt))
    expand_backup(tree, slot, st.path, meta[:, M_DEPTH], meta[:, M_PARENT],
                  meta[:, M_ACTION], alloc, meta[:, M_LEAF],
                  alloc & ~terminal, prep_priors(probs.to(dt), st.valid),
                  leaf_value)


def sim_step_reference(env, cfg: MCTSConfig, tree: Tree, st: SimState, probs,
                       value, prev_slot: int, slot: int):
    """Kernel 3: :func:`flush_reference` of the previous simulation into
    ``prev_slot``, then simulation ``slot``'s descent and leaf, written to
    ``st``."""
    flush_reference(tree, st, probs, value, prev_slot)
    dcap = st.path.shape[1]
    walk = descend(tree.stats, tree.prior, tree.children, cfg, False, dcap)
    lf = leaf_finish(env, tree, walk, slot)
    st.path.copy_(lf.path)
    st.apath.copy_(lf.apath)
    cols = (lf.depth, lf.parent, lf.action, lf.alloc, lf.leaf, lf.terminal,
            lf.won, lf.player)
    st.meta.copy_(torch.stack([c.to(torch.int32) for c in cols], dim=1))
    st.valid.copy_(lf.valid)
    st.obs.copy_(env.observation_from_board(lf.board, lf.player))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

K_SIM_STEP = CudaKernel("sim.cu", "az_sim_step", [
    _P, _P, _P,                          # stats prior children
    _P, _P, _P, _P,                      # board player mc lines
    _P, _P, _P, _P, _P,                  # path apath meta valid obs
    _P, _P,                              # probs value (previous simulation)
    _I, _I,                              # prev_slot slot
    _I, _I, _I, _I, _I, _I, _I, _I,      # B N A R C F L K
    _I, _I, _I, _I, _F, _P])             # dcap max_moves rules az c_puct stream
K_SIM_FLUSH = CudaKernel("sim.cu", "az_sim_flush", [
    _P, _P, _P,                          # stats prior children
    _P, _P, _P, _P, _P,                  # path meta valid probs value
    _I, _I, _I, _I, _I, _P])             # slot B N A dcap stream

KERNELS = [K_SIM_STEP, K_SIM_FLUSH]

SIM_THREADS = 128     # threads per CTA of both kernels
MAX_ACTIONS = 256     # the most actions they take (boards of <= 256 cells)


def sim_group(A: int) -> int:
    """Lanes per game of ``az_sim_step`` and ``az_sim_flush`` for A actions
    (``csrc/walk.cuh:group_size``): the smallest of 8, 16 and 32 that holds
    A, and 32 above that (a warp; each lane then reads up to 8 edges)."""
    if not 1 <= A <= MAX_ACTIONS:
        raise ValueError(f"the per-simulation kernels take 1 to "
                         f"{MAX_ACTIONS} actions, not {A}")
    return 8 if A <= 8 else 16 if A <= 16 else 32


def sim_geometry(B: int, A: int) -> dict:
    """Launch geometry of ``az_sim_step`` and ``az_sim_flush`` at B games
    of A actions: a group of G lanes per game, ``SIM_THREADS // G`` games
    per CTA, as many CTAs as the games need, and the edges a lane reads per
    walk step (a whole number of group widths: 4 up to 128 actions, 8
    above)."""
    if B < 1:
        raise ValueError(f"batch {B} < 1")
    G = sim_group(A)
    games = SIM_THREADS // G
    return {"lanes_per_game": G, "games_per_cta": games,
            "ctas": -(-B // games), "threads_per_cta": SIM_THREADS,
            "edges_per_lane": 1 if G < 32 else 4 if A <= 128 else 8}


def sim_kernel_geometry(B: int, A: int) -> dict:
    """:func:`sim_geometry` as the kernels' library reports it
    (``az_sim_geometry``; needs the CUDA toolkit).  Raises if the two
    disagree."""
    lib = load("sim.cu")
    lib.az_sim_geometry.argtypes = [_I, _I, _P]
    out = (ctypes.c_int * 5)()
    rc = lib.az_sim_geometry(B, A, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"az_sim_geometry: CUDA error {rc} "
                           f"({lib.az_error_string(rc).decode()})")
    got = dict(zip(("lanes_per_game", "games_per_cta", "ctas",
                    "threads_per_cta", "edges_per_lane"), out))
    if got != sim_geometry(B, A):
        raise RuntimeError(f"sim geometry: the kernels report {got}, "
                           f"sim_geometry gives {sim_geometry(B, A)}")
    return got


def _check_state(env, tree: Tree, st: SimState, probs, value, dev):
    B, N, _ = tree.stats.shape
    A = env.action_dim
    dcap = st.path.shape[1]
    f = torch.float32
    for name, t, dt, shape in (
            ("stats", tree.stats, f, (B, N, 3)),
            ("prior", tree.prior, f, (B, N, A)),
            ("children", tree.children, torch.int32, (B, N, A)),
            ("root_board", tree.root_board, torch.int8,
             (B, 2, env.rows, env.cols)),
            ("root_player", tree.root_player, torch.int32, (B,)),
            ("root_move_count", tree.root_move_count, torch.int32, (B,)),
            ("path", st.path, torch.int32, (B, dcap)),
            ("apath", st.apath, torch.int32, (B, dcap)),
            ("meta", st.meta, torch.int32, (B, META_COLS)),
            ("valid", st.valid, torch.bool, (B, A)),
            ("obs", st.obs, f, (B, env.feature_dim, env.rows, env.cols)),
            ("lines", st.lines, torch.int32, tuple(env.lines.shape)),
            ("probs", probs, f, (B, A)), ("value", value, f, (B,))):
        check(t, dt, shape, dev, name)


def sim_step(env, cfg: MCTSConfig, tree: Tree, st: SimState, probs, value,
             prev_slot: int, slot: int):
    """``az_sim_step`` for CUDA tensors, :func:`sim_step_reference` for CPU
    tensors."""
    if plain(tree.stats):
        return sim_step_reference(env, cfg, tree, st, probs, value,
                                  prev_slot, slot)
    dev = tree.stats.device
    _check_state(env, tree, st, probs, value, dev)
    B, N, A = tree.prior.shape
    L, K = st.lines.shape
    K_SIM_STEP(tree.stats.data_ptr(), tree.prior.data_ptr(),
               tree.children.data_ptr(), tree.root_board.data_ptr(),
               tree.root_player.data_ptr(), tree.root_move_count.data_ptr(),
               st.lines.data_ptr(), st.path.data_ptr(), st.apath.data_ptr(),
               st.meta.data_ptr(), st.valid.data_ptr(), st.obs.data_ptr(),
               probs.data_ptr(), value.data_ptr(), int(prev_slot), int(slot),
               B, N, A, env.rows, env.cols, env.feature_dim, L, K,
               st.path.shape[1], env.max_moves, env.rules,
               int(cfg.formula == "alphazero"), float(cfg.c_puct),
               stream(tree.stats))


def flush(env, tree: Tree, st: SimState, probs, value, slot: int):
    """``az_sim_flush`` for CUDA tensors, :func:`flush_reference` for CPU
    tensors."""
    if plain(tree.stats):
        return flush_reference(tree, st, probs, value, slot)
    dev = tree.stats.device
    _check_state(env, tree, st, probs, value, dev)
    B, N, A = tree.prior.shape
    K_SIM_FLUSH(tree.stats.data_ptr(), tree.prior.data_ptr(),
                tree.children.data_ptr(), st.path.data_ptr(),
                st.meta.data_ptr(), st.valid.data_ptr(), probs.data_ptr(),
                value.data_ptr(), int(slot), B, N, A, st.path.shape[1],
                stream(tree.stats))


PLAIN = SimpleNamespace(sim_step=sim_step_reference,
                        flush=lambda env, *a: flush_reference(*a))
DISPATCH = SimpleNamespace(sim_step=sim_step, flush=flush)


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def _search_tree(ops, env, cfg: MCTSConfig, eval_fn, boards, players,
                 move_counts, dones, use_dirichlet, noise) -> Tree:
    """The tree after root expansion and simulations 1..S-1."""
    B = boards.shape[0]
    S = cfg.num_simulations
    dev = boards.device
    with span("search.prepare"):
        tree = init_tree(env, boards, players, move_counts, S)
        st = SimState.create(env, B, S, dev)
        probs = torch.zeros((B, env.action_dim), dtype=torch.float32,
                            device=dev)
        value = torch.zeros((B,), dtype=torch.float32, device=dev)
    with span("search.root"):
        expand_root(env, cfg, tree, eval_fn, dones.to(torch.bool),
                    use_dirichlet, noise, None)
    with span("search.sims", S - 1):
        for slot in range(1, S):
            ops.sim_step(env, cfg, tree, st, probs, value, slot - 1, slot)
            probs, value = eval_fn(st.obs)
            probs = probs.to(torch.float32).contiguous()
            value = value.to(torch.float32).contiguous()
    if S > 1:
        with span("search.finish"):
            ops.flush(env, tree, st, probs, value, S - 1)
    return tree


def _search(ops, env, cfg, eval_fn, boards, players, move_counts, dones,
            generator, use_dirichlet, noise, dev) -> SearchResult:
    with span("search.move"):
        with span("search.prepare"):
            args = search_inputs(env, cfg, boards, players, move_counts,
                                 dones, generator, use_dirichlet, noise, dev)
        tree = _search_tree(ops, env, cfg, eval_fn, *args)
        with span("search.finish"):
            return search_result(tree)


def sim_search_reference(env, eval_fn, boards, players, move_counts, dones,
                         cfg: MCTSConfig, *, generator=None,
                         use_dirichlet=None, noise=None) -> SearchResult:
    """Plain PyTorch version of :func:`run_mcts_sim`, on the inputs'
    device."""
    return _search(PLAIN, env, cfg, eval_fn, boards, players, move_counts,
                   dones, generator, use_dirichlet, noise, boards.device)


def run_mcts_sim(env, eval_fn, boards, players, move_counts, dones,
                 cfg: MCTSConfig, *, generator=None, use_dirichlet=None,
                 noise=None, device="cuda") -> SearchResult:
    """One move's search for B games on the per-simulation engine, the JAX
    package's ``run_mcts_pallas``, with the same returns as ``run_mcts``.

    ``eval_fn(obs (B, F, R, C)) → (probs (B, A), value (B,))`` evaluates the
    root and every simulation's leaf.  The root prior is mixed with
    Dirichlet ``noise (B, A)`` (drawn from ``generator`` unless given) where
    ``use_dirichlet (B,)`` holds (default ``cfg.use_dirichlet``), then set
    to ``NEG`` where an action is illegal or the game finished (``dones``).
    On CUDA each simulation is one ``az_sim_step`` launch and one
    ``eval_fn`` call, and the last is flushed by ``az_sim_flush``; on the
    CPU the wrappers run the plain versions.
    """
    dev = resolve_device(device)
    return _search(DISPATCH, env, cfg, eval_fn, boards, players, move_counts,
                   dones, generator, use_dirichlet, noise, dev)
