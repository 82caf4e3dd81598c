"""alphazero_tpu_torch — the AlphaZero system on PyTorch and CUDA (Hopper).

A port of the JAX package ``alphazero_tpu`` that stays beside it as the
reference.  Plain tensor code is PyTorch; every kernel that the JAX package
wrote in Pallas for the TPU is a CUDA kernel written by hand for sm_90a
(``csrc/``), built with ``nvcc`` at first use (``ops/build.py``) and held
against a plain PyTorch version of the same function.

Ported so far: the connect4 outer iteration with the dense tower,
``training.loop.Trainer.iterate``: self-play collection (``collect`` →
``training.selfplay`` → ``search.fused.run_selfplay_chunk``), the learner
(``train_epoch`` → ``training.learner``), the gate (``gate`` →
``eval.arena.compare`` → ``search.mcts.run_mcts`` →
``search.fused.run_mcts_fused``) and promote or revert.

Layer map:
  config.py  — configuration dataclasses and presets
  envs/      — batched game rules on tensors
  models/    — the dense policy/value tower
  search/    — MCTS: whole-chunk self-play and the move search (kernels +
               plain versions), the ``run_mcts`` entry point
  eval/      — the arena (agents, matches, the gate's compare)
  ops/       — kernel build and ctypes binding
  csrc/      — CUDA sources
  data/      — replay ring of whole-game blocks, sampling, symmetries
  training/  — self-play bookkeeping, the learner and the trainer
"""

__version__ = "0.1.0"
