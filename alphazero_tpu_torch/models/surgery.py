"""Model surgery: grow a trained ViT to more transformer blocks.

Counterpart of the JAX package's ``models/surgery.py``: a deeper model is
built and freshly initialised, and every parameter whose name and shape are
in both (the embedding, the existing ``block_{i}``, the final norm and the
heads) is copied from the old one; blocks ``>= cfg.depth`` keep their
fresh initialisation.
"""

from __future__ import annotations

import dataclasses

import torch

from alphazero_tpu_torch.config import ModelConfig
from alphazero_tpu_torch.models import build_model, init_params


def expand_vit_depth(cfg: ModelConfig, env, params: dict, new_depth: int,
                     generator: torch.Generator):
    """``(new_cfg, new_model, new_params)`` with ``new_depth`` blocks; the
    fresh parameters are drawn from ``generator``, and the model and every
    parameter live on the device of ``params``."""
    if new_depth < cfg.depth:
        raise ValueError("can only grow depth, not shrink")
    new_cfg = dataclasses.replace(cfg, depth=new_depth)
    dev = next(iter(params.values())).device
    new_model = build_model(new_cfg, env).to(dev)
    new_params = init_params(new_model, generator)
    for name, w in params.items():
        if name in new_params and new_params[name].shape == w.shape:
            new_params[name] = w
    return new_cfg, new_model, new_params
