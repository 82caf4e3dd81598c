"""An evaluator with exact float arithmetic, for bitwise checks of the search.

Twin of the JAX package tests' ``_exact_stub_forwards``: per-action scores
are 1 + small integer stone counts (exact in float32 in any summation
order), priors are grid-aligned to 2⁻¹⁴ and the value is a function of the
stone count, so every engine sees the same bits and whole search
trajectories can be compared for equality.  :func:`drawn_board` gives the
finished-game cases of those checks a drawn position of each game.
"""

from __future__ import annotations

import torch


def exact_stub_evaluator(env):
    """``obs (B, F·RC)`` 0/1 float32 → ``(probs (B, A), value (B,))``."""
    n = env.feature_dim * env.rows * env.cols
    A = env.action_dim

    def evaluate(obs):
        mod = torch.arange(n, device=obs.device) % A
        groups = torch.stack([(mod == a).to(torch.float32) for a in range(A)])
        tot = obs.sum(dim=-1)
        w = 1.0 + (obs[:, None, :] * groups[None]).sum(dim=-1)       # (B, A)
        probs = w / w.sum(dim=-1, keepdim=True)
        probs = torch.floor(probs * 16384.0 + 0.5) / 16384.0
        value = (tot - 5.0 * torch.floor(tot / 5.0) - 2.0) / 4.0
        return probs, value

    return evaluate


def drawn_board(env) -> torch.Tensor:
    """A full board ``(2, R, C)`` int8 with no line for either player, the
    first player holding the extra stone of an odd board.

    connect4: the bottom row's columns belong to players 0 0 1 1 0 0 1, and
    every row up swaps them; tictactoe: X O X / X O O / O X X; gomoku:
    cell (r, c) belongs to player 0 where ``(c + 2r) mod 4 >= 2``, so no
    row, column or diagonal holds more than two stones of one player in a
    row."""
    R, C = env.rows, env.cols
    if env.name == "connect4":
        base = torch.tensor([0, 0, 1, 1, 0, 0, 1])
        owner = base[None, :] ^ (torch.arange(R)[:, None] % 2)
    elif env.name == "tictactoe":
        owner = torch.tensor([[0, 1, 0], [0, 1, 1], [1, 0, 0]])
    elif env.name.startswith("gomoku"):
        owner = ((torch.arange(C)[None] + 2 * torch.arange(R)[:, None]) % 4
                 >= 2).long()
    else:
        raise ValueError(f"no drawn board for {env.name!r}")
    return torch.stack([owner == 0, owner == 1]).to(torch.int8)
