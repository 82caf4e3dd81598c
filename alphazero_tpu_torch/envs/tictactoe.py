"""TicTacToe: 3×3, 3 in a row."""

from __future__ import annotations

from alphazero_tpu_torch.envs.core import RULES_CELLS, Env, dihedral_perms


class TicTacToe(Env):
    """Actions are flat cells ``r * cols + c``; the observation carries the
    to-move plane (``feature_dim = 3``)."""

    name = "tictactoe"
    rules = RULES_CELLS
    rows = 3
    cols = 3
    action_dim = 9
    max_moves = 9
    feature_dim = 3
    win_len = 3

    def place_cell(self, board, action):
        return action // self.cols, action % self.cols

    def valid_mask_board(self, board, move_count):
        return ((board[:, 0] + board[:, 1]) == 0).reshape(board.shape[0], -1)

    def symmetries(self):
        perms = dihedral_perms(self.rows, self.cols)
        return perms, perms                  # actions are cells
