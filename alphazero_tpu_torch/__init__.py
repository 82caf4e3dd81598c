"""alphazero_tpu_torch — the AlphaZero system on PyTorch and CUDA (Hopper).

A port of the JAX package ``alphazero_tpu`` that stays beside it as the
reference.  Plain tensor code is PyTorch; every kernel that the JAX package
wrote in Pallas for the TPU is a CUDA kernel written by hand for sm_90a
(``csrc/``), built with ``nvcc`` at first use (``ops/build.py``) and held
against a plain PyTorch version of the same function.

Ported so far: every TPU kernel of the JAX package and the outer
iteration, ``training.loop.Trainer.iterate``, for the dense tower (connect4,
gomoku), the conv ResNet (tictactoe, connect4, gomoku), AlphaZero's
batch-norm ResNet (``gomoku15-alphazero``; the port's own) and the ViT
(gomoku 7×7, with dropout in the learner and depth surgery), driven by the
command line ``python -m alphazero_tpu_torch train|eval|play|bench``
(``cli.py``):
self-play collection (``collect`` → ``training.selfplay``: the dense
tower's whole-chunk search ``search.fused.run_selfplay_chunk``, or one
``selfplay_step`` per move), the learner (``train_epoch`` →
``training.learner``), the gate (``gate`` → ``eval.arena.compare`` →
``search.mcts.run_mcts``, which runs ``search.fused.run_mcts_fused`` for
the dense tower, the per-simulation engine ``search.sim.run_mcts_sim`` for
other networks, the leaf-batched rounds of ``search.mcts.run_mcts_xla`` for
``leaf_batch > 1`` and its sequential form with rollouts for vanilla
search), promote or revert, the vanilla sanity match, checkpoints, metrics
and ``config.json``.  With ``AZ_FUSED_RESNET=1`` (``make_eval_fn(...,
fused_resnet=True)``) the ResNet evaluates through the fused tower kernel
``ops.resnet_tower``.  ``training.spmd_loop`` and ``parallel/`` train
over several ranks (``train --mesh``); ``strength.py`` runs the JAX
package's train-to-strength scripts as recipes.

Layer map:
  cli.py     — train / eval / play / bench subcommands (``__main__.py``)
  bench.py   — self-play throughput of every preset on one GPU
  strength.py — train to strength against vanilla search, one recipe per
               JAX script (``scripts/train_*.py``, ``validate_learning.py``)
  config.py  — configuration dataclasses, presets, ``config.json``
  envs/      — batched game rules on tensors
  models/    — the dense tower, the conv ResNets and the ViT,
               ``make_eval_fn``, depth surgery (``models.surgery``)
  search/    — MCTS: the whole-chunk self-play and move searches, the
               per-simulation engine (kernels + plain versions), the
               portable engine with leaf batching and rollouts, the
               ``run_mcts`` entry point
  eval/      — the arena (agents, matches, the gate's compare), human play
  ops/       — kernel build and ctypes binding, the fused ResNet tower
  csrc/      — CUDA sources
  data/      — replay ring of whole-game blocks, sampling, symmetries
  training/  — self-play bookkeeping, the learner and the trainer
  utils/     — metrics logger, checkpoints, profiling
"""

__version__ = "0.1.0"
