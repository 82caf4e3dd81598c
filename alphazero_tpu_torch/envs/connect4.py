"""Connect-4: 6×7 with gravity, 4 in a row."""

from __future__ import annotations

import numpy as np
import torch

from alphazero_tpu_torch.envs.core import RULES_GRAVITY, Env


class Connect4(Env):
    """Actions are columns; a stone drops to row
    ``rows - 1 - (stones already in the column)``."""

    name = "connect4"
    rules = RULES_GRAVITY
    rows = 6
    cols = 7
    action_dim = 7
    max_moves = 42
    feature_dim = 3
    win_len = 4

    def place_cell(self, board, action):
        occ = (board[:, 0] + board[:, 1]).to(torch.int32)        # (B, R, C)
        height = torch.gather(
            occ, 2, action.long()[:, None, None].expand(-1, self.rows, 1)
        ).sum(dim=(1, 2))
        return self.rows - 1 - height, action

    def valid_mask_board(self, board, move_count):
        return (board[:, 0, 0] + board[:, 1, 0]) == 0

    def path_cells(self, root_board, actions, mask):
        """Gravity along a path: move d drops onto the root's column height
        plus the earlier moves of the path in the same column."""
        D = actions.shape[1]
        heights = (root_board[:, 0].long() + root_board[:, 1].long()).sum(1)
        a = actions.long()
        base = torch.where(mask, torch.gather(heights, 1, a.clamp(0, self.cols - 1)),
                           torch.zeros_like(a))
        same = (a[:, :, None] == a[:, None, :]) & mask[:, :, None] & mask[:, None, :]
        earlier = torch.ones((D, D), dtype=torch.bool,
                             device=actions.device).tril(-1)
        row = self.rows - 1 - (base + (same & earlier).sum(-1))
        return row * self.cols + a

    def symmetries(self):
        """``(cell_perms (S, RC), action_perms (S, A))``: identity and the
        left-right flip (gravity rules out rotations)."""
        idx = np.arange(self.rows * self.cols).reshape(self.rows, self.cols)
        cell_perms = np.stack([idx.reshape(-1), np.fliplr(idx).reshape(-1)])
        cols = np.arange(self.cols)
        return cell_perms, np.stack([cols, cols[::-1]])
