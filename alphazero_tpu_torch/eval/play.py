"""Human against agent in the terminal.

Counterpart of the JAX package's ``eval/play.py``.  The agent searches a
batch of one game through ``search.mcts.run_mcts`` with root Dirichlet noise
off and plays the most-visited action; a human move is ``"row col"`` for a
cell game and a column number for connect4.  States are batches of one
(``env.init(1)``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.device import resolve_device
from alphazero_tpu_torch.search.mcts import run_mcts
from alphazero_tpu_torch.utils.profiling import span


def parse_input(env, state, text: str) -> Optional[int]:
    """The action a human typed for game 0 of ``state``, or None when the
    text is not a legal move."""
    try:
        parts = text.split()
        if env.action_dim == env.cols and env.rows != 1:   # connect4: column
            action = int(parts[0])
        else:
            action = int(parts[0]) * env.cols + int(parts[1])
    except (ValueError, IndexError):
        return None
    if not 0 <= action < env.action_dim:
        return None
    return action if bool(env.valid_mask(state)[0, action]) else None


def agent_move(env, eval_fn, state, generator, mcts_cfg: MCTSConfig,
               verbose: bool = True) -> int:
    """One search for game 0 of ``state`` on its device; prints each
    visited action's count and share and the root Q when ``verbose``.
    Returns the first most-visited action."""
    with span("play.move"):
        res = run_mcts(env, eval_fn, state.board, state.current_player,
                       state.move_count, state.done, mcts_cfg,
                       generator=generator, device=state.board.device)
        with span("play.readback"):
            counts = res.visit_counts[0].cpu()
        if verbose:
            total = max(int(counts.sum()), 1)
            for a in torch.nonzero(counts).reshape(-1).tolist():
                print(f"  action {a}: visits={int(counts[a])} "
                      f"p={int(counts[a]) / total:.3f}")
            print(f"  root Q: {float(res.root_q[0]):+.3f}")
        return int(counts.argmax())


def play_against_agent(env, eval_fn, mcts_cfg: MCTSConfig, human_turn: int,
                       input_fn=input, print_fn=print, rng_seed: int = 0,
                       device="cuda") -> int:
    """The interactive loop; returns the winner (0/1, -1 for a draw).
    ``eval_fn=None`` plays vanilla search, its rollouts drawn from a
    generator seeded with ``rng_seed``."""
    dev = resolve_device(device)
    state = env.init(1, dev)
    generator = torch.Generator(device=dev).manual_seed(rng_seed)
    cfg = dataclasses.replace(mcts_cfg, use_dirichlet=False)
    while True:
        print_fn(env.render(state))
        if int(state.current_player[0]) == human_turn:
            action = parse_input(env, state, input_fn("your move> "))
            if action is None:
                print_fn("Invalid move. Try again.")
                continue
        else:
            action = agent_move(env, eval_fn, state, generator, cfg)
            print_fn(f"agent plays {action}")
        state = env.step(state, torch.tensor([action], dtype=torch.int32,
                                             device=dev))
        if bool(state.done[0]):
            print_fn(env.render(state))
            w = int(state.winner[0])
            print_fn("It's a draw!" if w < 0 else f"Player {w} wins!")
            return w
