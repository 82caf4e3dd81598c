"""Batched neural-guided MCTS: the search entry point.

Counterpart of the JAX package's ``search/mcts.py`` (``SearchResult``,
``_prep_priors``, ``run_mcts``).  ``run_mcts`` dispatches an evaluator that
carries ``dense_spec`` (``models.make_eval_fn`` of the dense tower) to the
whole-move search of ``search/fused.py``, as the JAX package does on its
fused path.  The GPU has no lane alignment or VMEM budget, so every batch
size takes that path.  The XLA engine (``_simulate_once``, leaf batching)
and vanilla rollout search are module 3 of ROADMAP.md and not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from alphazero_tpu_torch.config import MCTSConfig

NEG = -1e30


@dataclasses.dataclass
class SearchResult:
    visit_counts: torch.Tensor   # (B, A) int32
    policy: torch.Tensor         # (B, A) float32, normalized visit counts
    root_q: torch.Tensor         # (B,) float32


def prep_priors(probs, valid):
    """Expansion priors with the finite ``NEG`` legality encoding."""
    return torch.where(valid, probs, torch.full_like(probs, NEG))


def run_mcts(env, eval_fn, boards, players, move_counts, dones,
             cfg: MCTSConfig, *, generator=None, use_dirichlet=None,
             noise=None, device="cuda") -> SearchResult:
    """Run ``cfg.num_simulations`` simulations from the given roots.

    ``noise (B, A)`` is the root Dirichlet noise, drawn from ``generator``
    unless given.  Raises ``NotImplementedError`` for what is not ported:
    vanilla search (``eval_fn=None``) and evaluators without ``dense_spec``
    or with ``leaf_batch > 1`` (the XLA engine), both module 3 of
    ROADMAP.md, and ``num_simulations + 2 >= 512``, where the JAX package
    leaves the fused path for that engine.
    """
    if eval_fn is None:
        raise NotImplementedError(
            "vanilla (rollout) search is module 3 of ROADMAP.md "
            "(search/mcts.py XLA engine with search/rollout.py), not ported")
    spec = getattr(eval_fn, "dense_spec", None)
    if (spec is None or cfg.leaf_batch != 1
            or cfg.num_simulations + 2 >= 512):
        raise NotImplementedError(
            "only the dense whole-move search is ported; the XLA engine "
            "(_simulate_once, leaf batching) is module 3 of ROADMAP.md")
    from alphazero_tpu_torch.search.fused import run_mcts_fused
    return run_mcts_fused(env, spec[0], spec[1], eval_fn, boards, players,
                          move_counts, dones, cfg, generator=generator,
                          use_dirichlet=use_dirichlet, noise=noise,
                          device=device)
