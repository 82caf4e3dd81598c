"""Plain batched PUCT search and the self-play move rules.

One search per game of a batch, every game live at its root:

* the root is evaluated; with root ``noise (B, A)`` its prior is
  ``(1 - eps)·p + eps·noise``; priors of illegal actions are never chosen;
  with ``quantize`` the priors are rounded to the 2⁻¹⁴ grid
  (``floor(p·16384 + 0.5) / 16384``, as the whole-move search stores them);
* each of the simulations 1..S-1 walks from the root by the first maximum
  of ``Q + prior·√N_parent / (n + 1)`` (the exploration term times
  ``c_puct`` for the ``alphazero`` formula; ``Q = 0`` for an unvisited
  edge), plays the walk's moves on a copy of the root board, and stops at a
  new edge or at a terminal node;
* a new edge's leaf is terminal on a win of the player who moved in (value
  1) or a full board (value 0), else it is evaluated (value ``-v``) and
  expanded; the value is backed up along the walk, negated per ply, with
  one visit per node;
* the result is the visit count of each root edge.

Everything is float32; the forward is any callable ``net(obs (B, F, R, C))
→ (probs, value)``.
"""

from __future__ import annotations

import torch

from azbench.reference.games import Game

NEG = -1e30


def qprior(p: torch.Tensor) -> torch.Tensor:
    return torch.floor(p * 16384.0 + 0.5) * (1.0 / 16384.0)


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    m = x.max(dim=-1, keepdim=True).values
    return (x == m).to(torch.int8).argmax(dim=-1)


def mix(probs, noise, eps: float):
    """The root prior with Dirichlet noise mixed in."""
    eps = float(torch.tensor(eps, dtype=torch.float32))
    return (1.0 - eps) * probs + eps * noise


@torch.no_grad()
def search(g: Game, net, board, player, mc, sims: int, formula: str,
           c_puct: float = 1.25, noise=None, eps: float = 0.25,
           quantize: bool = False) -> torch.Tensor:
    """Root visit counts ``(B, A)`` float32 of ``sims`` simulations from
    ``board (B, 2, R, C)``, ``player`` and ``mc (B,)``."""
    dev = board.device
    B, A, RC = board.shape[0], g.action_dim, g.cells
    N = sims + 1
    dcap = min(g.max_moves + 1, N)
    f32 = torch.float32
    ar = torch.arange(B, device=dev)
    player, mc = player.long(), mc.long()
    visit = torch.zeros((B, N), dtype=f32, device=dev)
    val = torch.zeros((B, N), dtype=f32, device=dev)
    expanded = torch.zeros((B, N), dtype=torch.bool, device=dev)
    child = torch.full((B, N, A), -1, dtype=torch.long, device=dev)
    prior = torch.zeros((B, N, A), dtype=f32, device=dev)
    legal = torch.zeros((B, N, A), dtype=torch.bool, device=dev)
    scale = float(torch.tensor(c_puct, dtype=f32))

    def put_prior(slot, probs, ok):
        p = qprior(probs) if quantize else probs
        prior[:, slot] = torch.where(ok, p, torch.zeros_like(p))
        legal[:, slot] = ok

    probs, value = net(g.observation(board, player))
    if noise is not None:
        probs = mix(probs, noise.to(f32), eps)
    put_prior(0, probs, g.legal(board))
    visit[:, 0] = 1.0
    val[:, 0] = -value
    expanded[:, 0] = True
    for slot in range(1, sims):
        node = torch.zeros(B, dtype=torch.long, device=dev)
        pv = visit[:, 0].clone()
        stop = torch.zeros(B, dtype=torch.bool, device=dev)
        depth = torch.zeros(B, dtype=torch.long, device=dev)
        parent = torch.zeros(B, dtype=torch.long, device=dev)
        action = torch.zeros(B, dtype=torch.long, device=dev)
        csel = torch.zeros(B, dtype=torch.long, device=dev)
        path = torch.zeros((B, dcap + 1), dtype=torch.long, device=dev)
        walk = board.clone()
        for d in range(dcap):
            if bool(stop.all()):
                break
            ch, pr = child[ar, node], prior[ar, node]
            has = ch >= 0
            chc = ch.clamp(min=0)
            zero = torch.zeros((), dtype=f32, device=dev)
            cv = torch.where(has, visit[ar[:, None], chc], zero)
            cl = torch.where(has, val[ar[:, None], chc], zero)
            q = torch.where(cv > 0, cl / torch.clamp(cv, min=1.0), zero)
            explore = pr * (torch.sqrt(pv)[:, None] / (cv + 1.0))
            if formula == "alphazero":
                explore = scale * explore
            ucb = torch.where(legal[ar, node], q + explore,
                              torch.full_like(q, NEG))
            act = first_argmax(ucb)
            c_sel = ch[ar, act]
            deeper = (c_sel >= 0) & expanded[ar, c_sel.clamp(min=0)]
            live = ~stop
            path[live, d] = node[live]
            parent = torch.where(live, node, parent)
            action = torch.where(live, act, action)
            csel = torch.where(live, c_sel, csel)
            depth = torch.where(live, torch.full_like(depth, d + 1), depth)
            pv = torch.where(live, cv[ar, act], pv)
            node = torch.where(live & deeper, c_sel, node)
            moved = g.play(walk, (player + d) % 2, act)
            walk = torch.where(live[:, None, None, None], moved, walk)
            stop = stop | ~deeper
        alloc = csel < 0
        leaf = torch.where(alloc, torch.full_like(csel, slot), csel)
        to_move = (player + depth) % 2
        won = g.won(walk, 1 - to_move)
        terminal = won | (mc + depth >= g.max_moves)
        probs, value = net(g.observation(walk, to_move))
        grow = alloc & ~terminal
        put_prior(slot, probs, grow[:, None] & g.legal(walk))
        expanded[:, slot] = grow
        child[ar[alloc], parent[alloc], action[alloc]] = slot
        leaf_value = torch.where(terminal, won.to(f32), -value.to(f32))
        path[ar, depth] = leaf
        for d in range(int(depth.max()) + 1):
            m = d <= depth
            sv = torch.where((depth - d) % 2 == 0, leaf_value, -leaf_value)
            visit[ar[m], path[m, d]] += 1.0
            val[ar[m], path[m, d]] += sv[m]
    ch0 = child[:, 0]
    return torch.where(ch0 >= 0, visit[ar[:, None], ch0.clamp(min=0)],
                       torch.zeros((), dtype=f32, device=dev))


def inverse_cdf_action(policy, u, mc, temperature_moves: int):
    """The whole-move search's action: before ``temperature_moves`` the
    first action whose running float32 sum of ``policy`` passes ``u`` (the
    last visited one when none does), after it the first most visited."""
    B, A = policy.shape
    greedy = first_argmax(policy)
    acc = torch.zeros(B, dtype=torch.float32, device=policy.device)
    sampled = torch.full((B,), A, dtype=torch.long, device=policy.device)
    for a in range(A):
        acc = acc + policy[:, a]
        sampled = torch.where((sampled == A) & (acc > u),
                              torch.full_like(sampled, a), sampled)
    ids = torch.arange(A, device=policy.device)
    last = torch.where(policy > 0, ids, -1).max(-1).values
    sampled = torch.where(sampled < A, sampled,
                          torch.where(last >= 0, last, greedy))
    return torch.where(mc.long() < temperature_moves, sampled, greedy)


def gumbel_action(policy, gumbel, t, temperature_moves: int):
    """The move-by-move self-play's action: before ``temperature_moves``
    ``argmax(log π + gumbel)`` over the visited actions, after it the first
    most visited."""
    logits = torch.where(policy > 0, torch.log(torch.clamp(policy, min=1e-30)),
                         torch.full_like(policy, -float("inf")))
    sampled = first_argmax(gumbel + logits)
    return torch.where(t.long() < temperature_moves, sampled,
                       first_argmax(policy))
