"""Plain rules of the benchmark's games: connect4 (6×7, gravity, 4 in a row)
and gomoku N×N (5 in a row, a move next to a stone, the centre to open).

Boards are ``(B, 2, R, C)`` int8 stone planes, plane p holding player p's
stones; player 0 moves first.  Written from the rules, independent of the
program under test.
"""

from __future__ import annotations

import dataclasses

import torch


def line_cells(rows: int, cols: int, k: int) -> list:
    """Flat cells of every straight run of ``k`` cells."""
    out = []
    for r in range(rows):
        for c in range(cols):
            for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
                er, ec = r + dr * (k - 1), c + dc * (k - 1)
                if 0 <= er < rows and 0 <= ec < cols:
                    out.append([(r + dr * i) * cols + c + dc * i
                                for i in range(k)])
    return out


_LINES: dict = {}


@dataclasses.dataclass(frozen=True)
class Game:
    name: str
    rows: int
    cols: int
    win_len: int
    gravity: bool
    # observation planes: the mover's stones, the opponent's, and (connect4)
    # a plane filled with the mover's id
    feature_dim: int

    @property
    def cells(self) -> int:
        return self.rows * self.cols

    @property
    def action_dim(self) -> int:
        return self.cols if self.gravity else self.cells

    @property
    def max_moves(self) -> int:
        return self.cells

    def lines(self, device) -> torch.Tensor:
        key = (self.rows, self.cols, self.win_len, str(device))
        if key not in _LINES:
            _LINES[key] = torch.tensor(
                line_cells(self.rows, self.cols, self.win_len),
                dtype=torch.long, device=device)
        return _LINES[key]

    def legal(self, board: torch.Tensor) -> torch.Tensor:
        """``(B, A)`` bool legal actions of (unfinished) boards."""
        occ = (board[:, 0] + board[:, 1]) > 0                     # (B, R, C)
        if self.gravity:
            return ~occ[:, 0]
        B = board.shape[0]
        near = torch.nn.functional.max_pool2d(
            occ[:, None].float(), 3, stride=1, padding=1)[:, 0] > 0
        moves = (near & ~occ).reshape(B, -1)
        centre = torch.zeros_like(moves)
        centre[:, (self.rows // 2) * self.cols + self.cols // 2] = True
        empty = ~occ.reshape(B, -1).any(-1, keepdim=True)
        return torch.where(empty, centre, moves)

    def cell_of(self, board: torch.Tensor, action: torch.Tensor):
        """Flat cell where ``action (B,)`` lands."""
        a = action.long()
        if not self.gravity:
            return a
        occ = (board[:, 0] + board[:, 1]).long()                  # (B, R, C)
        height = occ.sum(1).gather(1, a[:, None])[:, 0]
        return (self.rows - 1 - height) * self.cols + a

    def play(self, board, player, action):
        """Board after ``player (B,)`` plays ``action (B,)``."""
        B = board.shape[0]
        out = board.reshape(B, 2, -1).clone()
        ar = torch.arange(B, device=board.device)
        out[ar, player.long(), self.cell_of(board, action)] = 1
        return out.reshape(board.shape)

    def won(self, board, player) -> torch.Tensor:
        """``(B,)`` bool: ``player`` has a full line."""
        B = board.shape[0]
        ar = torch.arange(B, device=board.device)
        plane = board[ar, player.long()].reshape(B, -1) > 0
        return plane[:, self.lines(board.device)].all(-1).any(-1)

    def observation(self, board, player) -> torch.Tensor:
        """``(B, F, R, C)`` float32 planes from the mover's side."""
        p = player.long()[:, None, None]
        mine = torch.where(p == 0, board[:, 0], board[:, 1])
        theirs = torch.where(p == 0, board[:, 1], board[:, 0])
        planes = [mine, theirs]
        if self.feature_dim == 3:
            planes.append(p.to(board.dtype).expand(-1, self.rows, self.cols))
        return torch.stack(planes, 1).float()

    def board_from_observation(self, obs, player) -> torch.Tensor:
        """Inverse of :meth:`observation` (int8 boards)."""
        p = player.long()[:, None, None]
        mine, theirs = obs[:, 0].to(torch.int8), obs[:, 1].to(torch.int8)
        return torch.stack([torch.where(p == 0, mine, theirs),
                            torch.where(p == 0, theirs, mine)], 1)


def game(env: str) -> Game:
    """The rules of a configuration's ``env`` name."""
    if env == "connect4":
        return Game("connect4", 6, 7, 4, True, 3)
    if env.startswith("gomoku"):
        n = int(env[len("gomoku"):] or 7)
        return Game(f"gomoku{n}", n, n, 5, False, 2)
    raise ValueError(f"no reference rules for {env!r}")
