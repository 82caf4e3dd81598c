"""Game environments: tictactoe, connect4 and gomoku (7×7, 9×9, 15×15)."""

from alphazero_tpu_torch.envs.connect4 import Connect4
from alphazero_tpu_torch.envs.core import Env, EnvState, dihedral_perms
from alphazero_tpu_torch.envs.gomoku import Gomoku
from alphazero_tpu_torch.envs.tictactoe import TicTacToe


def make_env(name: str) -> Env:
    """Build an env by name: 'tictactoe', 'connect4', 'gomoku' (7×7) or
    'gomoku{N}'."""
    if name == "tictactoe":
        return TicTacToe()
    if name == "connect4":
        return Connect4()
    if name.startswith("gomoku"):
        size = int(name[len("gomoku"):]) if len(name) > len("gomoku") else 7
        return Gomoku(size)
    raise ValueError(f"unknown env: {name!r}")


__all__ = ["Env", "EnvState", "Connect4", "Gomoku", "TicTacToe",
           "dihedral_perms", "make_env"]
