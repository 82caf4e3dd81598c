"""alphazero_tpu_torch — the AlphaZero system on PyTorch and CUDA (Hopper).

A port of the JAX package ``alphazero_tpu`` that stays beside it as the
reference.  Plain tensor code is PyTorch; every kernel that the JAX package
wrote in Pallas for the TPU is a CUDA kernel written by hand for sm_90a
(``csrc/``), built with ``nvcc`` at first use (``ops/build.py``) and held
against a plain PyTorch version of the same function.

Ported so far: the outer iteration, ``training.loop.Trainer.iterate``, for
the dense tower (connect4) and the conv ResNet (tictactoe, connect4,
gomoku):
self-play collection (``collect`` → ``training.selfplay``: the dense
tower's whole-chunk search ``search.fused.run_selfplay_chunk``, or one
``selfplay_step`` per move), the learner (``train_epoch`` →
``training.learner``), the gate (``gate`` → ``eval.arena.compare`` →
``search.mcts.run_mcts``, which runs ``search.fused.run_mcts_fused`` for
the dense tower, the per-simulation engine ``search.sim.run_mcts_sim`` for
other networks and the portable engine ``search.mcts.run_mcts_xla`` with
rollouts for vanilla search), promote or revert, and the vanilla sanity
match.

Layer map:
  config.py  — configuration dataclasses and presets
  envs/      — batched game rules on tensors
  models/    — the dense tower and the conv ResNet
  search/    — MCTS: the whole-chunk self-play and move searches, the
               per-simulation engine (kernels + plain versions), the
               portable engine and rollouts, the ``run_mcts`` entry point
  eval/      — the arena (agents, matches, the gate's compare)
  ops/       — kernel build and ctypes binding
  csrc/      — CUDA sources
  data/      — replay ring of whole-game blocks, sampling, symmetries
  training/  — self-play bookkeeping, the learner and the trainer
"""

__version__ = "0.1.0"
