"""MCTS: the whole-chunk self-play search and the move search."""
