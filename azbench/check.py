"""The comparisons that decide ``correct``: the program's records judged by
the plain reference (``azbench/reference``).

* :func:`ring_bad`: every game block in the replay ring replayed by the
  rules: positions from an empty board, one stone of the mover a move on a
  legal cell, visit distributions that are counts of ``sims - 1`` visits
  on legal actions with the move played among them, no line before the
  end, and a winner (or a draw on a full board) that the last move gives.
* :func:`chunk_bad`, :func:`step_bad`: the moves of a self-play call, each
  move's action by the rule of its engine from its own visit counts and
  the draws handed in, and the position after it by the rules.
* :func:`tv` of :func:`reference_policy`: the total-variation distance
  between the program's root visit distributions and the reference
  search's, on the same positions and root noise, with the reference's
  float32 forward.
* :class:`Recorder`, :class:`Replay`, :func:`logit_gaps`: a search
  followed from the program's own forwards (its visit counts must be the
  reference's exactly), and those forwards against the reference's.
"""

from __future__ import annotations

import torch

from azbench.reference import search
from azbench.reference.games import Game


def _policy_ok(policy, legal, sims: int):
    """``(N,)`` bool: a row of ``sims - 1`` visits on legal actions."""
    n = sims - 1
    counts = policy * n
    whole = (counts - torch.round(counts)).abs() <= 1e-3
    return (whole.all(-1) & (policy >= 0).all(-1)
            & (torch.round(counts).sum(-1) == n)
            & ((policy == 0) | legal).all(-1))


def ring_bad(g: Game, buf, sims: int) -> tuple:
    """``(blocks checked, blocks wrong)`` of the ring ``buf`` (fields
    ``obs (G, L, F, R, C)``, ``policy (G, L, A)``, ``length``, ``winner``,
    ``size``)."""
    G = int(buf.size)
    if G == 0:
        return 0, 0
    obs = buf.obs[:G]
    pol = buf.policy[:G].float()
    n = buf.length[:G].long()
    win = buf.winner[:G].long()
    L = obs.shape[1]
    dev = obs.device
    t = torch.arange(L, device=dev)
    player = (t % 2).expand(G, L).reshape(-1)
    flat = obs.reshape((G * L,) + obs.shape[2:])
    boards = g.board_from_observation(flat.float(), player)
    boards = boards.reshape((G, L, 2, g.cells)).long()
    live = t[None] < n[:, None]                                  # (G, L)
    bad = (n < 1) | (n > L)
    # stone counts of each side before move t, and the to-move plane
    want0, want1 = (t + 1) // 2, t // 2
    stones = boards.sum(-1)                                      # (G, L, 2)
    bad |= (live & ((stones[..., 0] != want0) | (stones[..., 1] != want1))
            ).any(-1)
    if g.feature_dim == 3:
        bad |= (live[..., None, None]
                & (obs[:, :, 2].long() != (t % 2)[None, :, None, None])
                ).flatten(1).any(-1)
    legal = g.legal(boards.reshape((G * L, 2, g.rows, g.cols)).to(
        torch.int8)).reshape(G, L, -1)
    bad |= (live & ~_policy_ok(pol.reshape(G * L, -1),
                               legal.reshape(G * L, -1), sims
                               ).reshape(G, L)).any(-1)
    # a line before the last position ends the game early
    lines = g.lines(dev)
    either = (boards[..., 0, :][..., lines].all(-1).any(-1)
              | boards[..., 1, :][..., lines].all(-1).any(-1))
    bad |= (live & either).any(-1)
    # move t → t+1: one new stone of the mover, on the cell its action
    # lands on, an action the search visited
    step = live[:, 1:]
    diff = boards[:, 1:] - boards[:, :-1]               # (G, L-1, 2, RC)
    mover = (t[:-1] % 2)[None, :].expand(G, L - 1)
    added = diff.clamp(min=0).sum((-1, -2))
    removed = (diff < 0).any(-1).any(-1)
    cell = diff.sum(-2).argmax(-1)                                # (G, L-1)
    own = torch.gather(diff, 2, mover[..., None, None].expand(
        G, L - 1, 1, g.cells)).sum((-1, -2))
    action = cell % g.cols if g.gravity else cell
    src = boards[:, :-1].reshape((G * (L - 1), 2, g.rows, g.cols)).to(
        torch.int8)
    lands = g.cell_of(src, action.reshape(-1)).reshape(G, L - 1)
    visited = torch.gather(pol[:, :-1], 2, action[..., None])[..., 0] > 0
    ok = (added == 1) & ~removed & (own == 1) & (lands == cell) & visited
    bad |= (step & ~ok).any(-1)
    # the end: the last move wins for its mover (winner) or fills the
    # board (draw), by some visited action
    gi = torch.arange(G, device=dev)
    last = (n - 1).clamp(min=0)
    lb = boards[gi, last].reshape(G, 2, g.rows, g.cols).to(torch.int8)
    lp = last % 2
    A = g.action_dim
    acts = torch.arange(A, device=dev)
    rep = lb.repeat_interleave(A, 0)
    after = g.play(rep, lp.repeat_interleave(A), acts.repeat(G))
    wins = g.won(after, lp.repeat_interleave(A)).reshape(G, A)
    cand = (pol[gi, last] > 0) & legal[gi, last]
    bad |= (win >= 0) & ((win != lp) | ~(cand & wins).any(-1))
    bad |= (win < 0) & ((n != g.max_moves) | (cand & wins).any(-1))
    bad |= (win < -1) | (win > 1)
    return G, int(bad.sum())


def _after_move(g: Game, board, player, mc, action):
    """Board, done and winner after ``action`` by the rules."""
    nxt = g.play(board, player, action)
    won = g.won(nxt, player)
    done = won | (mc.long() + 1 >= g.max_moves)
    winner = torch.where(won, player.long(), torch.full_like(player.long(),
                                                             -1))
    return nxt, done, winner


def chunk_bad(g: Game, start, rec, unif, sims: int,
              temperature_moves: int) -> tuple:
    """``(moves checked, moves wrong)`` of one whole-chunk call: ``start``
    is ``(board, player, mc)`` before it, ``rec`` its move-major records,
    ``unif (M, B)`` the uniforms handed in."""
    board, player, mc = start
    M, B = rec["action"].shape
    wrong = torch.zeros(B, dtype=torch.long, device=board.device)
    for m in range(M):
        pol, act = rec["policy"][m].float(), rec["action"][m].long()
        bad = (rec["player"][m].long() != player.long()) \
            | (rec["t"][m].long() != mc.long())
        bad |= (g.observation(board, player).to(torch.int8)
                != rec["obs"][m]).flatten(1).any(-1)
        legal = g.legal(board)
        bad |= ~_policy_ok(pol, legal, sims)
        bad |= act != search.inverse_cdf_action(pol, unif[m], mc,
                                                temperature_moves)
        nxt, done, winner = _after_move(g, board, player, mc, act)
        bad |= (rec["done"][m] != done) | (rec["winner"][m].long() != winner)
        wrong += bad.long()
        board = torch.where(done[:, None, None, None],
                            torch.zeros_like(nxt), nxt)
        player = torch.where(done, torch.zeros_like(player), 1 - player)
        mc = torch.where(done, torch.zeros_like(mc), mc + 1)
    wrong += ((rec["board"] != board).flatten(1).any(-1)
              | (rec["player_final"].long() != player.long())
              | (rec["mc_final"].long() != mc.long())).long()
    return M * B, int(wrong.sum())


def step_bad(g: Game, before, after, policy, gumbel, sims: int,
             temperature_moves: int) -> int:
    """Games wrong in one move-by-move self-play step: ``before`` and
    ``after`` are ``(board, player, t)``, ``policy`` the step's recorded
    visit distributions, ``gumbel`` the draws handed in."""
    board, player, t = before
    legal = g.legal(board)
    bad = ~_policy_ok(policy.float(), legal, sims)
    act = search.gumbel_action(policy.float(), gumbel, t, temperature_moves)
    nxt, done, _ = _after_move(g, board, player, t, act)
    want = torch.where(done[:, None, None, None], torch.zeros_like(nxt), nxt)
    bad |= (after[0] != want).flatten(1).any(-1)
    bad |= after[1].long() != torch.where(done, 0, 1 - player.long())
    bad |= after[2].long() != torch.where(done, 0, t.long() + 1)
    return int(bad.sum())


def tv(p, q) -> torch.Tensor:
    """``(B,)`` total-variation distance of two distributions per row."""
    return 0.5 * (p.float() - q.float()).abs().sum(-1)


def reference_policy(g: Game, net, board, player, mc, mcts: dict,
                     noise=None, quantize=False):
    counts = search.search(g, net, board, player, mc, mcts["num_simulations"],
                           mcts["formula"], mcts["c_puct"], noise=noise,
                           eps=mcts["dirichlet_eps"], quantize=quantize)
    return counts / counts.sum(-1, keepdim=True).clamp(min=1.0)


class Recorder:
    """An evaluator that keeps every call's input and outputs."""

    def __init__(self, eval_fn, calls=None):
        self.eval_fn = eval_fn
        self.calls = [] if calls is None else calls

    def __call__(self, obs):
        probs, value = self.eval_fn(obs)
        self.calls.append((obs.clone(), probs.float().clone(),
                           value.float().clone()))
        return probs, value

    def take(self) -> list:
        out = list(self.calls)
        self.calls.clear()
        return out


class Replay:
    """An evaluator that gives back recorded outputs in order, counting per
    row the calls whose input differs from the recorded one."""

    def __init__(self, calls):
        self.calls = calls
        self.i = 0
        self.mismatch = None

    def __call__(self, obs):
        o, p, v = self.calls[self.i]
        self.i += 1
        bad = (o.reshape(o.shape[0], -1) != obs.reshape(obs.shape[0], -1)
               ).any(-1).long()
        self.mismatch = bad if self.mismatch is None else self.mismatch + bad
        return p, v


def logit_gaps(net, calls, rows: int = 4096) -> list:
    """Per row of each recorded call, the widest gap between the program's
    outputs and the reference forward ``net``'s, in logits: the policy's
    log-probabilities centred per row (softmax ignores a shift) and the
    value's ``atanh``.  The reference runs ``rows`` rows at a time."""
    obs = torch.cat([o.reshape(o.shape[0], -1) for o, _, _ in calls])
    p = torch.cat([c[1] for c in calls])
    v = torch.cat([c[2] for c in calls])
    shape = calls[0][0].shape[1:]
    out = []
    for i in range(0, obs.shape[0], rows):
        rp, rv = net(obs[i:i + rows].reshape((-1,) + tuple(shape)))
        lp, lr = (torch.log(x.float().clamp(min=1e-30))
                  for x in (p[i:i + rows], rp))
        d = (lp - lp.mean(-1, keepdim=True)) - (lr - lr.mean(-1, keepdim=True))
        z = (torch.atanh(v[i:i + rows].float().clamp(-1 + 1e-6, 1 - 1e-6))
             - torch.atanh(rv.float().clamp(-1 + 1e-6, 1 - 1e-6)))
        out.append(torch.maximum(d.abs().max(-1).values, z.abs()))
    return out
