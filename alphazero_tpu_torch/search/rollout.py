"""Batched uniform-random rollouts for vanilla (model-free) MCTS.

Counterpart of the JAX package's ``search/rollout.py``: from each position
play uniformly random legal moves until a win or a full board, and score
the result ±1/0 for the player who moved into the position.
"""

from __future__ import annotations

import torch


def rollout_values(env, boards, players, move_counts, generator):
    """Random playouts from ``boards (B, 2, R, C)`` with ``players`` to
    move after ``move_counts`` moves, drawn from ``generator``.  Returns
    ``(B,)`` float32 in {-1, 0, 1} from the perspective of ``1 - players``.
    """
    B = boards.shape[0]
    dev = boards.device
    board = boards.to(torch.int8).clone()
    player = players.to(torch.int32).clone()
    mc = move_counts.to(torch.int32).clone()
    winner = torch.full((B,), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    ar = torch.arange(B, device=dev)
    while not bool(done.all()):
        valid = env.valid_mask_board(board, mc)
        has_valid = valid.any(-1)
        # a uniform choice among the legal actions (action 0 when none)
        u = torch.rand(valid.shape, generator=generator, device=dev)
        action = torch.where(valid, u, -1.0).argmax(-1).to(torch.int32)
        moved = ~done & has_valid
        new_board = env.apply_action(board, player, torch.where(
            moved, action, torch.zeros_like(action)))
        board = torch.where(moved[:, None, None, None], new_board, board)
        won = env.won_batch(board[ar, player.long()]) & moved
        winner = torch.where(won, player, winner)
        mc = mc + moved.to(torch.int32)
        player = torch.where(moved, 1 - player, player)
        done = done | won | (mc >= env.max_moves) | ~has_valid
    leaf_mover = 1 - players.to(torch.int32)
    one = torch.ones((B,), dtype=torch.float32, device=dev)
    return torch.where(winner < 0, 0.0 * one,
                       torch.where(winner == leaf_mover, one, -one))
