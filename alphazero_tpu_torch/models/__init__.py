"""Policy/value networks and evaluator adapters.  Only the dense family is
ported so far."""

from __future__ import annotations

import torch
from torch.func import functional_call

from alphazero_tpu_torch.config import ModelConfig
from alphazero_tpu_torch.models.dense import (DenseTower, init_params,
                                              params_from_flax)


def build_model(cfg: ModelConfig, env) -> DenseTower:
    """The configured network for an env's geometry."""
    if cfg.family != "dense":
        raise ValueError(f"model family {cfg.family!r} is not ported yet")
    return DenseTower(
        rows=env.rows, cols=env.cols, action_dim=env.action_dim,
        channels_in=env.feature_dim, win_len=env.win_len,
        width=cfg.width, blocks=cfg.blocks,
        dtype=getattr(torch, cfg.compute_dtype),
    )


def make_eval_fn(model: DenseTower, params: dict):
    """Batched evaluator ``obs (B, F, R, C) → (softmax over ALL actions,
    value)``.  There is no legality mask: illegal actions' priors are never
    selected by the search.  ``eval_fn.dense_spec = (model, params)`` lets
    ``search.mcts.run_mcts`` dispatch to the whole-move search."""

    @torch.no_grad()
    def eval_fn(obs):
        logits, value = functional_call(model, params, (obs,))
        return torch.softmax(logits, dim=-1), value

    eval_fn.dense_spec = (model, params)
    return eval_fn


__all__ = ["DenseTower", "build_model", "init_params", "make_eval_fn",
           "params_from_flax"]
