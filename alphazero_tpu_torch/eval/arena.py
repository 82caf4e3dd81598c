"""Batched arena: model-vs-model and model-vs-vanilla matches.

Counterpart of the JAX package's ``eval/arena.py``: B games advance in
lockstep for ``env.max_moves`` moves.  At move t player ``t % 2`` is to move
in every game (finished games no-op without passing the turn), so each
agent searches only its half of the batch: agent_a plays player 0 in games
``[0, B/2)`` and player 1 in ``[B/2, B)``.  Draws score half a point.

Before ``sampling_moves`` an action is drawn from the root visit
distribution as ``argmax(log π + gumbel)`` over visited actions (the JAX
package's ``jax.random.categorical``), after it is the first most-visited
action.  The random draws (root Dirichlet noise, vanilla search's rollouts
and the gumbel noise) come from one ``torch.Generator`` unless handed in
through ``draws``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.device import resolve_device
from alphazero_tpu_torch.envs.core import EnvState
from alphazero_tpu_torch.search.mcts import first_argmax, run_mcts


@dataclasses.dataclass(frozen=True)
class Agent:
    """One arena participant: a network evaluator, or vanilla search with
    random rollouts (``eval_fn=None``), and its search settings."""

    eval_fn: Optional[Callable] = None
    mcts: MCTSConfig = MCTSConfig()
    # arena searches keep root Dirichlet noise on, as the JAX package's do
    dirichlet: bool = True


def gumbel_noise(shape, generator, device) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, ``u`` uniform in
    ``[tiny, 1)``."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp(min=tiny)
    return -torch.log(-torch.log(u))


def _agent_actions(env, agent: Agent, states: EnvState, t: int,
                   sampling_moves: int, generator, noise, gumbel, device):
    """This agent's action for each of its games, and its search result."""
    cfg = dataclasses.replace(agent.mcts, use_dirichlet=agent.dirichlet)
    res = run_mcts(env, agent.eval_fn, states.board, states.current_player,
                   states.move_count, states.done, cfg, generator=generator,
                   noise=noise, device=device)
    if t >= sampling_moves:
        return first_argmax(res.visit_counts).to(torch.int32), res
    logits = torch.where(res.visit_counts > 0,
                         torch.log(torch.clamp(res.policy, min=1e-30)),
                         torch.full_like(res.policy, -float("inf")))
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, generator, device)
    return first_argmax(gumbel + logits).to(torch.int32), res


def _rows(states: EnvState, sl: slice) -> EnvState:
    return EnvState(*(getattr(states, f.name)[sl]
                      for f in dataclasses.fields(EnvState)))


def make_play_games(env, agent_a: Agent, agent_b: Agent,
                    sampling_moves: int = 0, device="cuda") -> Callable:
    """``play(B, *, generator=None, draws=None, trace=None) → winner_agent
    (B,)`` int32: 0 = agent_a, 1 = agent_b, -1 draw, with the side swap at
    B/2.

    ``draws``, when given, holds the random numbers the match would draw:
    ``{"noise": (max_moves, 2, B/2, A), "gumbel": (max_moves, 2, B/2, A)}``
    for (move, agent a/b); either may be missing.  ``trace``, a list,
    receives per search ``(t, agent, done (B/2,), visit_counts (B/2, A))``.
    """
    dev = resolve_device(device)

    def play(B: int, *, generator=None, draws=None, trace=None):
        if B % 2:
            raise ValueError("the side swap needs an even game count")
        h = B // 2
        draws = draws or {}
        states = env.init(B, dev)
        for t in range(env.max_moves):
            lo, hi = slice(0, h), slice(h, B)
            halves = (lo, hi) if t % 2 == 0 else (hi, lo)
            acts = []
            for k, (agent, sl) in enumerate(zip((agent_a, agent_b), halves)):
                s = _rows(states, sl)
                noise, gumbel = (draws[name][t, k].to(dev)
                                 if name in draws else None
                                 for name in ("noise", "gumbel"))
                act, res = _agent_actions(env, agent, s, t, sampling_moves,
                                          generator, noise, gumbel, dev)
                acts.append(act)
                if trace is not None:
                    trace.append((t, k, s.done, res.visit_counts))
            action = torch.cat(acts if t % 2 == 0 else acts[::-1])
            states = env.step(states, action)
        winner = states.winner
        a_first = torch.arange(B, device=dev) < h
        a_won = (winner == 0) == a_first
        return torch.where(winner < 0, -1,
                           torch.where(a_won, 0, 1)).to(torch.int32)

    return play


def match_score(winners, games: int):
    """(contender win rate with draws as 0.5, [best, contender, draws])
    from a winner vector of :func:`make_play_games` (best is agent_a)."""
    w = np.asarray(winners)
    best_w = float((w == 0).sum())
    cont_w = float((w == 1).sum())
    draws = float((w == -1).sum())
    score = np.array([best_w + 0.5 * draws, cont_w + 0.5 * draws, draws])
    return float(score[1] / games), score


def compare(env, best: Agent, contender: Agent, games: int, *,
            generator=None, sampling: bool = False, sampling_moves: int = 20,
            device="cuda"):
    """Head-to-head match of ``games`` games, all at once, with the side
    swap at ``games // 2``.  Returns (contender win rate with draws as 0.5,
    [best, contender, draws])."""
    play = make_play_games(env, best, contender,
                           sampling_moves=sampling_moves if sampling else 0,
                           device=device)
    w = play(games, generator=generator)
    return match_score(w.cpu().numpy(), games)
