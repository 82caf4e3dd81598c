"""MCTS: the whole-chunk self-play and move searches, the per-simulation
engine, the portable engine with rollouts, and the ``run_mcts`` entry
point."""
