"""Gomoku: N×N, 5 in a row; the size is a constructor argument (7, 9, 15)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from alphazero_tpu_torch.envs.core import (RULES_NEIGHBOURHOOD, Env,
                                           dihedral_perms)


class Gomoku(Env):
    """Actions are flat cells; the observation has no to-move plane
    (``feature_dim = 2``).  A move is legal on an empty cell next to a stone
    (8-neighbourhood), and the centre is the only opening move."""

    rules = RULES_NEIGHBOURHOOD
    feature_dim = 2
    win_len = 5

    def __init__(self, size: int = 7):
        self.rows = self.cols = size
        self.action_dim = self.max_moves = size * size
        self.name = f"gomoku{size}"
        super().__init__()

    def place_cell(self, board, action):
        return action // self.cols, action % self.cols

    def valid_mask_board(self, board, move_count):
        B = board.shape[0]
        occ = (board[:, 0] + board[:, 1]).to(torch.float32)      # (B, R, C)
        near = F.max_pool2d(occ[:, None], 3, stride=1, padding=1)[:, 0]
        mask = (near > 0) & (occ == 0)
        center = torch.zeros_like(mask)
        center[:, self.rows // 2, self.cols // 2] = True
        empty = (occ.reshape(B, -1).sum(-1) == 0)[:, None, None]
        return torch.where(empty, center, mask).reshape(B, -1)

    def symmetries(self):
        perms = dihedral_perms(self.rows, self.cols)
        return perms, perms
