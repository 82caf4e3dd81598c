"""Batched two-player board games on tensors.

Counterpart of the JAX package's ``envs/core.py``.  Every method takes a
batch: boards are ``(B, 2, R, C)`` int8 stone planes (plane p holds player
p's stones), players and move counts are ``(B,)`` int32.  Win detection
reads the cells of every straight ``win_len``-run from a line table, which
gives the same answer as the JAX package's ``board_flat @ W == win_len``
with no matrix product.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class EnvState:
    """A batch of game states.

    Attributes:
      board: ``(B, 2, R, C)`` int8 stone planes.
      current_player: ``(B,)`` int32, player to move (0 or 1).
      move_count: ``(B,)`` int32, moves played so far.
      winner: ``(B,)`` int32, -1 none, else 0/1.
      done: ``(B,)`` bool, game over (win or board full).
    """

    board: torch.Tensor
    current_player: torch.Tensor
    move_count: torch.Tensor
    winner: torch.Tensor
    done: torch.Tensor


def _make_line_matrix(rows: int, cols: int, win_len: int) -> np.ndarray:
    """The 0/1 cell→line membership matrix ``W (rows*cols, L)``.

    Lines enumerate every straight ``win_len``-run: horizontal, vertical and
    both diagonals, in the JAX package's order.
    """
    lines = []
    for r in range(rows):
        for c in range(cols):
            for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
                er, ec = r + dr * (win_len - 1), c + dc * (win_len - 1)
                if 0 <= er < rows and 0 <= ec < cols:
                    lines.append(
                        [(r + dr * k) * cols + (c + dc * k) for k in range(win_len)]
                    )
    W = np.zeros((rows * cols, len(lines)), dtype=np.float32)
    for j, line in enumerate(lines):
        W[line, j] = 1.0
    return W


def line_cells(rows: int, cols: int, win_len: int) -> np.ndarray:
    """``(L, win_len)`` int32 flat cells of each line of the line matrix."""
    W = _make_line_matrix(rows, cols, win_len)
    return np.stack([np.nonzero(W[:, j])[0] for j in range(W.shape[1])]
                    ).astype(np.int32)


# a game's move rules, as the CUDA search kernels read them
# (``csrc/sim.cu``): a move fills its cell and any empty cell is legal; a
# move drops down its column (connect4); an empty cell next to a stone is
# legal, the centre alone on an empty board (gomoku)
RULES_CELLS, RULES_GRAVITY, RULES_NEIGHBOURHOOD = 0, 1, 2


class Env:
    """Base class: subclasses set the geometry and the move ``rules`` and
    implement ``place_cell`` and ``valid_mask_board``."""

    name: str
    rules: int
    rows: int
    cols: int
    action_dim: int
    max_moves: int
    feature_dim: int
    win_len: int

    def __init__(self):
        self.lines = line_cells(self.rows, self.cols, self.win_len)

    # ---------------------------------------------------------------- helpers
    def won_batch(self, planes: torch.Tensor) -> torch.Tensor:
        """``planes (..., R, C)`` → bool ``(...)``: a completed line."""
        flat = planes.reshape(planes.shape[:-2] + (-1,)) != 0
        idx = torch.as_tensor(self.lines, dtype=torch.long, device=planes.device)
        return flat[..., idx].all(dim=-1).any(dim=-1)

    # -------------------------------------------------------------------- API
    def init(self, batch_size: int, device="cpu") -> EnvState:
        B = batch_size
        return EnvState(
            board=torch.zeros((B, 2, self.rows, self.cols), dtype=torch.int8,
                              device=device),
            current_player=torch.zeros((B,), dtype=torch.int32, device=device),
            move_count=torch.zeros((B,), dtype=torch.int32, device=device),
            winner=torch.full((B,), -1, dtype=torch.int32, device=device),
            done=torch.zeros((B,), dtype=torch.bool, device=device),
        )

    def place_cell(self, board: torch.Tensor, action: torch.Tensor):
        """``(row, col)`` ``(B,)`` where ``action`` lands on ``board``."""
        raise NotImplementedError

    def apply_action(self, board, player, action):
        """Board with ``player``'s stone placed at ``action`` (per game)."""
        r, c = self.place_cell(board, action)
        out = board.clone()
        ar = torch.arange(board.shape[0], device=board.device)
        out[ar, player.long(), r.long(), c.long()] = 1
        return out

    def valid_mask_board(self, board, move_count) -> torch.Tensor:
        """Bool ``(B, action_dim)`` of legal actions on raw boards."""
        raise NotImplementedError

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """Apply ``action`` for each current player; finished games pass
        through unchanged."""
        p = state.current_player
        board = self.apply_action(state.board, p, action)
        ar = torch.arange(board.shape[0], device=board.device)
        won = self.won_batch(board[ar, p.long()])
        move_count = state.move_count + 1
        winner = torch.where(won, p, torch.full_like(p, -1))
        done = won | (move_count >= self.max_moves)
        d = state.done
        return EnvState(
            board=torch.where(d[:, None, None, None], state.board, board),
            current_player=torch.where(d, p, 1 - p),
            move_count=torch.where(d, state.move_count, move_count),
            winner=torch.where(d, state.winner, winner),
            done=torch.where(d, state.done, done),
        )

    def valid_mask(self, state: EnvState) -> torch.Tensor:
        """Bool ``(B, action_dim)`` of legal actions (all False when done)."""
        return self.valid_mask_board(state.board, state.move_count) \
            & ~state.done[:, None]

    def observation_from_board(self, board, player) -> torch.Tensor:
        """Canonical network input ``(B, feature_dim, R, C)`` float32:
        planes (player-to-move stones, opponent stones[, to-move plane
        filled with the player id])."""
        is0 = (player == 0)[:, None, None]
        mine = torch.where(is0, board[:, 0], board[:, 1])
        theirs = torch.where(is0, board[:, 1], board[:, 0])
        planes = [mine, theirs]
        if self.feature_dim == 3:
            planes.append(player.to(torch.int8)[:, None, None]
                          .expand(-1, self.rows, self.cols))
        return torch.stack(planes, dim=1).to(torch.float32)

    def observation(self, state: EnvState) -> torch.Tensor:
        return self.observation_from_board(state.board, state.current_player)

    def path_cells(self, root_board, actions, mask) -> torch.Tensor:
        """Flat cell ``(B, D)`` of each move of a path from ``root_board``;
        actions are cells unless a game overrides this (connect4)."""
        return actions

    def apply_path(self, root_board, root_player, actions, mask):
        """Board after playing ``actions (B, D)`` where ``mask (B, D)``
        holds, from ``root_board (B, 2, R, C)`` with players alternating
        from ``root_player (B,)``.  Stones are placed by index, which gives
        the boards of the JAX package's one-hot sum."""
        B, D = actions.shape
        RC = self.rows * self.cols
        cells = self.path_cells(root_board, actions, mask).long()
        parity = (root_player.long()[:, None]
                  + torch.arange(D, device=actions.device)[None]) % 2
        out = root_board.to(torch.int8).reshape(B, 2, RC).clone()
        b, d = torch.nonzero(mask, as_tuple=True)
        out[b, parity[b, d], cells[b, d]] = 1
        return out.reshape(B, 2, self.rows, self.cols)

    def render(self, state: EnvState, index: int = 0) -> str:
        """Game ``index`` of ``state`` as text, as the JAX package draws it:
        column digits on top, a row digit per row, ``O`` for player 0, ``X``
        for player 1, ``.`` for an empty cell."""
        board = state.board[index].cpu().numpy()
        out = ["  " + " ".join(str(c % 10) for c in range(self.cols))]
        for r in range(self.rows):
            row = ["O" if board[0, r, c] else ("X" if board[1, r, c] else ".")
                   for c in range(self.cols)]
            out.append(f"{r % 10} " + " ".join(row))
        return "\n".join(out)

    def symmetries(self):
        """``(cell_perms (S, RC), action_perms (S, A))`` of the game's
        symmetry group: ``new_plane = plane[cell_perms[s]]``."""
        raise NotImplementedError


def dihedral_perms(rows: int, cols: int) -> np.ndarray:
    """Cell permutations of the 8 dihedral symmetries of a square board, in
    the JAX package's order: r0, r0·lr, r0·tb, r90, r90·lr, r90·tb, r180,
    r270."""
    if rows != cols:
        raise ValueError("dihedral-8 needs a square board")
    idx = np.arange(rows * cols).reshape(rows, cols)
    perms = []
    for k in (0, 1, 2, 3):
        rot = np.rot90(idx, k=k)
        perms.append(rot.reshape(-1))
        if k in (0, 1):
            perms.append(np.fliplr(rot).reshape(-1))
            perms.append(np.flipud(rot).reshape(-1))
    return np.stack(perms)
