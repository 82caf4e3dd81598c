"""Arena matches between agents."""

from alphazero_tpu_torch.eval.arena import Agent, compare, make_play_games

__all__ = ["Agent", "compare", "make_play_games"]
