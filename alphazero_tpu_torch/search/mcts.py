"""Batched MCTS: the search entry point and the portable engine.

Counterpart of the JAX package's ``search/mcts.py``.  :func:`run_mcts`
dispatches, as the JAX package does on its accelerator:

* any network evaluator with ``leaf_batch > 1``, the dense tower's
  included, to the leaf-batched rounds of :func:`run_mcts_xla`;
* an evaluator with ``dense_spec`` (``models.make_eval_fn`` of the dense
  tower) to the whole-move search of ``search/fused.py`` where
  ``fused.supports_chunk`` accepts the game, the tower and the config;
* every other network evaluator to the per-simulation engine
  (``search/sim.py``, the JAX package's Pallas ``_sim_kernel`` /
  ``_flush_kernel``), at any batch size: the GPU has no lane alignment or
  VMEM budget;
* vanilla search (``eval_fn=None``, UCB1 with random rollouts) to
  :func:`run_mcts_xla`, the twin of the JAX package's portable engine.

The portable engine is the JAX ``_descend_arrays`` / ``_simulate_once`` with
direct indexing in place of one-hot gathers: descend every tree to its
frontier, rebuild the leaf board from the path, check the terminal, evaluate
(network or rollout), expand into the simulation's slot and back up along
the path.  :func:`descend`, :func:`leaf_finish` and :func:`expand_backup`
are also the parts the per-simulation engine's plain versions are made of,
so the two engines agree exactly.  Leaf batching (:func:`simulate_round`,
the JAX ``_simulate_round``) runs K virtual-loss descents, one evaluation of
the K·B leaves and K backups per round.

Semantics: PUCT ``Q + prior·√N_parent/(n+1)`` (times ``c_puct`` for the
``alphazero`` formula), UCB1 ``Q + √(2·ln N_parent/(n+1))`` for vanilla
search, terminal backup 1 for the mover's win and 0 for a draw, ``-value``
for network leaves, negation per ply, first maximum in ascending action
order.  A finished game's root stays unexpanded: every simulation ends at
the root as a terminal leaf and its counts stay 0.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.device import resolve_device
from alphazero_tpu_torch.search.rollout import rollout_values
from alphazero_tpu_torch.search.tree import (EXPANDED, NEG, VALUE, VISIT,
                                             Tree, init_tree, root_q,
                                             root_visit_counts)

__all__ = ["NEG", "SearchResult", "prep_priors", "run_mcts", "run_mcts_xla"]


@dataclasses.dataclass
class SearchResult:
    visit_counts: torch.Tensor   # (B, A) int32
    policy: torch.Tensor         # (B, A) float32, normalized visit counts
    root_q: torch.Tensor         # (B,) float32


def prep_priors(probs, valid, vanilla: bool = False):
    """Expansion priors with the finite ``NEG`` legality encoding (0 on
    legal actions for vanilla search)."""
    fill = torch.full_like(probs, NEG)
    return torch.where(valid, torch.zeros_like(probs) if vanilla else probs,
                       fill)


def first_argmax(x):
    """First index of the maximum along the last dim (ascending tie-break)."""
    m = x.max(dim=-1, keepdim=True).values
    return (x == m).to(torch.int8).argmax(dim=-1)


def ucb(prior_row, cvisit, cvalue, pv, cfg: MCTSConfig, vanilla: bool):
    """UCB of each action from its child's stats; ``prior_row`` is ``NEG`` at
    illegal actions (multiplied in for PUCT, added for UCB1)."""
    zero = torch.zeros((), dtype=cvisit.dtype, device=cvisit.device)
    q = torch.where(cvisit > 0, cvalue / torch.clamp(cvisit, min=1.0), zero)
    if vanilla:
        explore = torch.sqrt(
            2.0 * torch.log(torch.clamp(pv, min=1.0))[:, None] / (cvisit + 1.0))
        return q + explore + prior_row
    explore = prior_row * (torch.sqrt(pv)[:, None] / (cvisit + 1.0))
    if cfg.formula == "alphazero":
        explore = torch.tensor(cfg.c_puct, dtype=explore.dtype) * explore
    return q + explore


def descend(stats, prior, children, cfg: MCTSConfig, vanilla: bool,
            dcap: int):
    """Walk every tree root→frontier.  Returns per game ``path (B, dcap)``
    (interior nodes, N past the walk), ``apath (B, dcap)`` (actions, 0 past
    the walk), ``depth``, ``parent``, ``action`` and ``child`` ``(B,)``
    int64; ``child < 0`` means the edge was never taken, ``parent < 0``
    that the root itself is the leaf (an unexpanded, finished root)."""
    B, N = stats.shape[:2]
    dev = stats.device
    ar = torch.arange(B, device=dev)
    node = torch.zeros(B, dtype=torch.long, device=dev)
    pv = stats[:, 0, VISIT].clone()
    stop = stats[:, 0, EXPANDED] == 0
    depth = torch.zeros(B, dtype=torch.long, device=dev)
    parent = torch.full((B,), -1, dtype=torch.long, device=dev)
    action = torch.zeros(B, dtype=torch.long, device=dev)
    child = torch.zeros(B, dtype=torch.long, device=dev)
    path = torch.full((B, dcap), N, dtype=torch.int32, device=dev)
    apath = torch.zeros((B, dcap), dtype=torch.int32, device=dev)
    for d in range(dcap):
        if bool(stop.all()):
            break
        prior_row = prior[ar, node]                                 # (B, A)
        child_row = children[ar, node].long()
        has = (child_row >= 0)[..., None]
        cs = torch.where(has, stats[ar[:, None], child_row.clamp(min=0)],
                         torch.zeros((), dtype=stats.dtype, device=dev))
        cvisit, cvalue, cexp = cs[..., VISIT], cs[..., VALUE], cs[..., EXPANDED]
        act = first_argmax(ucb(prior_row, cvisit, cvalue, pv, cfg, vanilla))
        c_sel = child_row[ar, act]
        now_stop = (c_sel < 0) | (cexp[ar, act] == 0)
        live = ~stop
        path[:, d] = torch.where(live, node, N).to(torch.int32)
        apath[:, d] = torch.where(live, act, 0).to(torch.int32)
        parent = torch.where(live, node, parent)
        action = torch.where(live, act, action)
        child = torch.where(live, c_sel, child)
        depth = torch.where(live, d + 1, depth)
        node = torch.where(live & ~now_stop, c_sel, node)
        pv = torch.where(live, cvisit[ar, act], pv)
        stop = stop | now_stop
    return path, apath, depth, parent, action, child


@dataclasses.dataclass
class Leaf:
    """One simulation's leaf, per game: the walk and what the leaf is."""

    path: torch.Tensor        # (B, dcap) int32
    apath: torch.Tensor       # (B, dcap) int32
    depth: torch.Tensor       # (B,) int64
    parent: torch.Tensor
    action: torch.Tensor
    alloc: torch.Tensor       # (B,) bool: a new edge, expanded into ``slot``
    leaf: torch.Tensor        # (B,) int64 node that receives the leaf ply
    terminal: torch.Tensor    # (B,) bool
    won: torch.Tensor         # (B,) bool: the player who moved in won
    player: torch.Tensor      # (B,) int64 to move at the leaf
    board: torch.Tensor       # (B, 2, R, C) int8
    move_count: torch.Tensor  # (B,) int64
    valid: torch.Tensor       # (B, A) bool legal actions at the leaf


def leaf_finish(env, tree: Tree, walk, slot: int) -> Leaf:
    """The leaf of a :func:`descend` walk: its board rebuilt from the path,
    the terminal check (a win for the player who moved in, or a full board;
    an unexpanded root is terminal), the node that receives it (``slot``
    for a new edge) and its legal actions."""
    path, apath, depth, parent, action, child = walk
    B, dcap = apath.shape
    dev = apath.device
    root_case = parent < 0
    alloc = (parent >= 0) & (child < 0)
    leaf = torch.where(root_case, 0, torch.where(alloc, slot, child))
    move_mask = torch.arange(dcap, device=dev)[None] < depth[:, None]
    board = env.apply_path(tree.root_board, tree.root_player, apath,
                           move_mask)
    player = (tree.root_player.long() + depth) % 2
    mc = tree.root_move_count.long() + depth
    ar = torch.arange(B, device=dev)
    won = env.won_batch(board[ar, 1 - player])
    root_unexp = tree.stats[:, 0, EXPANDED] == 0
    terminal = (((won | (mc >= env.max_moves)) & ~root_case)
                | (root_case & root_unexp))
    return Leaf(path, apath, depth, parent, action, alloc, leaf, terminal,
                won, player, board, mc, env.valid_mask_board(board, mc))


def expand_backup(tree: Tree, slot: int, path, depth, parent, action, alloc,
                  leaf, do_expand, prior_slot, leaf_value):
    """Expansion into slot ``slot`` (its prior row where ``do_expand``, else
    ``NEG``; the parent's edge points at the slot where ``alloc``) and the
    backup of ``leaf_value`` along ``path`` with the leaf at ``depth``: one
    visit per ply, the value negated per ply, the expanded flag at the leaf
    where ``do_expand``."""
    B = path.shape[0]
    dev = path.device
    tree.prior[:, slot] = torch.where(do_expand[:, None], prior_slot,
                                      torch.full_like(prior_slot, NEG))
    b = torch.arange(B, device=dev)[alloc]
    tree.children[b, parent[alloc], action[alloc]] = slot
    add_backup(tree.stats, leaf_path(path, depth, leaf), depth, leaf_value,
               do_expand)


def leaf_path(path, depth, leaf):
    """``(B, dcap + 1)`` int64: each walk's ``path`` with its ``leaf`` at
    ply ``depth``, so that a walk cut at its cap (depth == dcap) keeps its
    leaf; the columns past ``depth`` are not plies of the walk."""
    pos = torch.arange(path.shape[1] + 1, device=path.device)[None]
    padded = torch.cat([path.long(), leaf[:, None].long()], dim=1)
    return torch.where(pos == depth[:, None], leaf[:, None], padded)


def _plies(full_path, depth):
    """``(bi, di, nodes)``: game, ply and node of plies ``0..depth`` of
    each game's ``full_path`` (distinct nodes within a path)."""
    pos = torch.arange(full_path.shape[1], device=full_path.device)[None]
    bi, di = torch.nonzero(pos <= depth[:, None], as_tuple=True)
    return bi, di, full_path[bi, di]


def add_backup(stats, full_path, depth, leaf_value, do_expand):
    """Add one backup to ``stats``: a visit per ply of ``full_path`` up to
    the leaf at ``depth``, ``leaf_value`` negated per ply up from the leaf,
    the expanded flag at the leaf where ``do_expand``."""
    bi, di, nodes = _plies(full_path, depth)
    lv = leaf_value[bi]
    even = (depth[bi] - di) % 2 == 0
    stats[bi, nodes, VISIT] += 1.0
    stats[bi, nodes, VALUE] += torch.where(even, lv, -lv)
    stats[bi, nodes, EXPANDED] += ((di == depth[bi])
                                   & do_expand[bi]).to(stats.dtype)


def simulate_once(env, cfg: MCTSConfig, tree: Tree, slot: int, eval_fn,
                  generator, dcap: int):
    """One simulation of the portable engine for every game: descend,
    rebuild the leaf, evaluate it (``eval_fn`` or a rollout), expand into
    ``slot`` and back up."""
    vanilla = eval_fn is None
    dt = tree.stats.dtype
    walk = descend(tree.stats, tree.prior, tree.children, cfg, vanilla, dcap)
    lf = leaf_finish(env, tree, walk, slot)
    if vanilla:
        probs = torch.zeros(lf.valid.shape, dtype=dt,
                            device=tree.stats.device)
        eval_value = rollout_values(env, lf.board, lf.player, lf.move_count,
                                    generator).to(dt)
    else:
        probs, value = eval_fn(env.observation_from_board(lf.board,
                                                          lf.player))
        probs, eval_value = probs.to(dt), (-value).to(dt)
    do_expand = lf.alloc & ~lf.terminal
    leaf_value = torch.where(lf.terminal, lf.won.to(dt), eval_value)
    expand_backup(tree, slot, lf.path, lf.depth, lf.parent, lf.action,
                  lf.alloc, lf.leaf, do_expand,
                  prep_priors(probs, lf.valid, vanilla), leaf_value)


def simulate_round(env, cfg: MCTSConfig, tree: Tree, slot_base: int,
                   eval_fn, dcap: int):
    """One leaf-batched round of ``K = cfg.leaf_batch`` simulations, the
    JAX package's ``_simulate_round``: K descents on a copy of the tree
    annotated with virtual losses (each descent's path gains a visit and
    ``-virtual_loss`` at once, and its new edge points at its slot at once,
    so a later descent revisits the pending leaf), one ``eval_fn`` call on
    the K·B leaves, K expansions into slots ``slot_base + k``, then all K
    backups, summed over the ranks in rank order and added to the tree's
    stats together.  Ranks past the simulation budget park on the spare
    slot N-1 with their effects masked."""
    B, N = tree.stats.shape[:2]
    A = env.action_dim
    K = cfg.leaf_batch
    S = cfg.num_simulations
    dt = tree.stats.dtype
    dev = tree.stats.device
    pos = torch.arange(dcap, device=dev)[None]
    ar = torch.arange(B, device=dev)
    stats_v = tree.stats.clone()
    children_v = tree.children.clone()
    ranks = []
    for k in range(K):
        active = slot_base + k < S
        slot = slot_base + k if active else N - 1
        path, apath, depth, parent, action, child = descend(
            stats_v, tree.prior, children_v, cfg, False, dcap)
        root_case = parent < 0
        alloc = (parent >= 0) & (child < 0)
        leaf = torch.where(root_case, 0, torch.where(alloc, slot, child))
        full_path = leaf_path(path, depth, leaf)
        if active:
            children_v[ar[alloc], parent[alloc], action[alloc]] = slot
            bi, _, nodes = _plies(full_path, depth)
            stats_v[bi, nodes, VISIT] += 1.0
            stats_v[bi, nodes, VALUE] += -cfg.virtual_loss
        ranks.append((apath, depth, root_case, alloc, slot, active,
                      full_path))

    # one forward for the K·B leaves, rank-major
    apaths = torch.stack([r[0] for r in ranks])                 # (K, B, dcap)
    depths = torch.stack([r[1] for r in ranks])                 # (K, B)
    move_mask = (pos[None] < depths[..., None]).reshape(K * B, dcap)
    board = env.apply_path(tree.root_board.repeat(K, 1, 1, 1),
                           tree.root_player.repeat(K),
                           apaths.reshape(K * B, dcap), move_mask)
    player = (tree.root_player.long().repeat(K) + depths.reshape(-1)) % 2
    mc = tree.root_move_count.long().repeat(K) + depths.reshape(-1)
    won = env.won_batch(board[torch.arange(K * B, device=dev),
                              1 - player]).reshape(K, B)
    root_cases = torch.stack([r[2] for r in ranks])
    root_unexp = tree.stats[:, 0, EXPANDED] == 0
    terminal = (((won | (mc.reshape(K, B) >= env.max_moves)) & ~root_cases)
                | (root_cases & root_unexp[None]))
    probs, value = eval_fn(env.observation_from_board(board, player))
    probs = probs.to(dt).reshape(K, B, A)
    eval_value = (-value).to(dt).reshape(K, B)
    valid = env.valid_mask_board(board, mc).reshape(K, B, A)
    leaf_value = torch.where(terminal, won.to(dt), eval_value)

    # K expansions, then the K backups summed in rank order
    contrib = torch.zeros_like(tree.stats)
    for k, (_, depth, _, alloc, slot, active, full_path) in enumerate(ranks):
        do_expand = alloc & ~terminal[k] & active
        tree.prior[:, slot] = torch.where(
            do_expand[:, None], prep_priors(probs[k], valid[k]),
            torch.full_like(probs[k], NEG))
        if active:
            add_backup(contrib, full_path, depth, leaf_value[k], do_expand)
    tree.stats += contrib
    tree.children = children_v


def _gamma(alpha: float, n: int, generator, device) -> torch.Tensor:
    """``n`` Gamma(alpha) draws: Marsaglia–Tsang, with the ``U^(1/alpha)``
    boost for alpha < 1 (``torch.distributions.Gamma`` takes no
    generator)."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(n, dtype=torch.float32, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        k = todo.numel()
        x = torch.randn(k, generator=generator, device=device)
        u = torch.rand(k, generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp(min=1e-30)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if alpha < 1.0:
        out = out * torch.rand(n, generator=generator,
                               device=device) ** (1.0 / alpha)
    return out


def dirichlet_noise(M: int, A: int, B: int, alpha: float, generator,
                    device) -> torch.Tensor:
    """``(M, A, B)`` symmetric Dirichlet(alpha) noise, normalized over A."""
    g = _gamma(alpha, M * A * B, generator, device).reshape(M, A, B)
    return g / g.sum(dim=1, keepdim=True)


def search_inputs(env, cfg, boards, players, move_counts, dones, generator,
                  use_dirichlet, noise, dev):
    """A network search's roots on ``dev``, its ``use_dirichlet (B,)`` flags
    (default ``cfg.use_dirichlet``) and root noise ``(B, A)``, drawn from
    ``generator`` unless given (or not needed)."""
    B = boards.shape[0]
    if use_dirichlet is None:
        use_dirichlet = torch.full((B,), bool(cfg.use_dirichlet), device=dev)
        drawn = bool(cfg.use_dirichlet)
    else:
        use_dirichlet = use_dirichlet.to(device=dev, dtype=torch.bool)
        drawn = True
    if noise is None and drawn:
        noise = dirichlet_noise(1, env.action_dim, B, cfg.dirichlet_alpha,
                                generator, dev)[0].T
    if noise is not None:
        noise = noise.to(dev, torch.float32).contiguous()
    return (boards.to(dev), players.to(dev), move_counts.to(dev),
            dones.to(dev), use_dirichlet, noise)


def root_prior(env, cfg: MCTSConfig, eval_fn, board, player, mc, dones,
               use_dirichlet, noise, dtype=torch.float32):
    """A network search's root: one ``eval_fn`` forward, the Dirichlet mix
    ``(1-eps)·p + eps·noise`` where ``use_dirichlet`` holds (when ``noise``
    is given), then ``NEG`` where an action is illegal or the game finished
    (``dones``).  Returns ``(prior (B, A), value (B,), live (B,))``, the
    floats in ``dtype``."""
    probs, value = eval_fn(env.observation_from_board(board, player))
    probs, value = probs.to(dtype), value.to(dtype).contiguous()
    if noise is not None:
        noisy = (1.0 - cfg.dirichlet_eps) * probs \
            + cfg.dirichlet_eps * noise.to(dtype)
        probs = torch.where(use_dirichlet[:, None], noisy, probs)
    live = ~dones.to(device=board.device, dtype=torch.bool)
    prior = torch.where(
        live[:, None], prep_priors(probs, env.valid_mask_board(board, mc)),
        torch.full_like(probs, NEG))
    return prior, value, live


def expand_root(env, cfg: MCTSConfig, tree: Tree, eval_fn, dones,
                use_dirichlet, noise, generator):
    """Simulation 0: evaluate the roots (:func:`root_prior`, or a rollout
    for vanilla search), write the root priors (``NEG`` for a finished game)
    and the root's stats: one visit, ``-value`` and expanded for a live
    game, none of it for a finished one."""
    dt = tree.stats.dtype
    board, player, mc = tree.root_board, tree.root_player, tree.root_move_count
    if eval_fn is None:
        live = ~dones
        tree.prior[:, 0] = torch.where(
            live[:, None] & env.valid_mask_board(board, mc),
            torch.zeros((), dtype=dt, device=board.device),
            torch.full((), NEG, dtype=dt, device=board.device))
        v0 = rollout_values(env, board, player, mc, generator).to(dt)
    else:
        tree.prior[:, 0], value, live = root_prior(
            env, cfg, eval_fn, board, player, mc, dones, use_dirichlet, noise,
            dt)
        v0 = -value
    zero = torch.zeros_like(v0)
    tree.stats[:, 0] = torch.stack([zero + 1.0, torch.where(live, v0, zero),
                                    live.to(dt)], dim=-1)


def search_result(tree: Tree) -> SearchResult:
    counts = root_visit_counts(tree)
    total = torch.clamp(counts.sum(-1), min=1).to(torch.float32)
    return SearchResult(visit_counts=counts,
                        policy=counts.to(torch.float32) / total[:, None],
                        root_q=root_q(tree))


def run_mcts_xla(env, eval_fn, boards, players, move_counts, dones,
                 cfg: MCTSConfig, *, generator=None, use_dirichlet=None,
                 noise=None, dtype=torch.float32,
                 device="cuda") -> SearchResult:
    """The portable engine (the JAX package's ``run_mcts(backend="xla")``):
    root expansion, then simulations 1..S-1 of :func:`simulate_once`, or,
    for a network evaluator with ``cfg.leaf_batch = K > 1``, ``ceil((S-1)/K)``
    rounds of :func:`simulate_round` from slots ``1 + r·K``.
    ``eval_fn=None`` is vanilla search with rollouts drawn from
    ``generator``; ``noise (B, A)`` is the root Dirichlet noise (drawn from
    ``generator`` unless given), ``dtype`` the tree's float type."""
    dev = resolve_device(device)
    if eval_fn is None:
        use_dirichlet = noise = None
        boards, players, move_counts, dones = (
            x.to(dev) for x in (boards, players, move_counts, dones))
    else:
        boards, players, move_counts, dones, use_dirichlet, noise = \
            search_inputs(env, cfg, boards, players, move_counts, dones,
                          generator, use_dirichlet, noise, dev)
    S = cfg.num_simulations
    tree = init_tree(env, boards, players, move_counts, S, dtype)
    dcap = int(min(env.max_moves + 1, S + 1))
    expand_root(env, cfg, tree, eval_fn, dones.to(torch.bool), use_dirichlet,
                noise, generator)
    K = cfg.leaf_batch
    if eval_fn is not None and K > 1:
        for r in range(-(-(S - 1) // K)):
            simulate_round(env, cfg, tree, 1 + r * K, eval_fn, dcap)
    else:
        for slot in range(1, S):
            simulate_once(env, cfg, tree, slot, eval_fn, generator, dcap)
    return search_result(tree)


def run_mcts(env, eval_fn, boards, players, move_counts, dones,
             cfg: MCTSConfig, *, generator=None, use_dirichlet=None,
             noise=None, device="cuda") -> SearchResult:
    """Run ``cfg.num_simulations`` simulations from the given roots, on the
    engine the evaluator calls for (see the module note).

    ``noise (B, A)`` is the root Dirichlet noise, drawn from ``generator``
    unless given; ``generator`` also draws vanilla search's rollouts.
    """
    if eval_fn is None:
        return run_mcts_xla(env, None, boards, players, move_counts, dones,
                            cfg, generator=generator, device=device)
    kw = dict(generator=generator, use_dirichlet=use_dirichlet, noise=noise,
              device=device)
    if cfg.leaf_batch > 1:
        return run_mcts_xla(env, eval_fn, boards, players, move_counts, dones,
                            cfg, **kw)
    spec = getattr(eval_fn, "dense_spec", None)
    if spec is not None:
        from alphazero_tpu_torch.search import fused
        if fused.supports_chunk(env, spec[0], cfg):
            return fused.run_mcts_fused(env, spec[0], spec[1], eval_fn,
                                        boards, players, move_counts, dones,
                                        cfg, **kw)
    from alphazero_tpu_torch.search.sim import run_mcts_sim
    return run_mcts_sim(env, eval_fn, boards, players, move_counts, dones,
                        cfg, **kw)
