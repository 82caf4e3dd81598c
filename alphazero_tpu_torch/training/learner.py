"""SGD learner: Adam on replay samples.

Counterpart of the JAX package's ``training/learner.py``.  Loss = soft-target
policy cross-entropy + value MSE + ``l2_coeff`` · Σw² over every parameter
not named ``bias`` (LayerNorm scales and the ViT's embeddings included, as
in the JAX package).  The network runs under autograd through
``functional_call``, in plain PyTorch: the JAX learner runs no Pallas
kernel.  The ViT trains with dropout on, its masks drawn from an explicit
``dropout_generator`` (the JAX learner's ``dropout_rng``); the dense tower
and the ResNet have no dropout and ignore it.  Adam is created fresh for
every epoch; ``torch.optim.Adam``'s defaults (β 0.9/0.999, eps 1e-8) are
optax's.  Float32 matrix products stay full float32 (PyTorch's default; no
TF32).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from alphazero_tpu_torch.config import TrainConfig
from alphazero_tpu_torch.data.replay import ReplayBuffer, sample
from alphazero_tpu_torch.models.vit import ViT


class TrainMetrics(NamedTuple):
    loss: torch.Tensor
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    l2: torch.Tensor


def l2_penalty(params: dict) -> torch.Tensor:
    """Σ w² over all parameters except those named ``bias``."""
    total = 0.0
    for name, w in params.items():
        if name.rsplit(".", 1)[-1] == "bias":
            continue
        total = total + (w.to(torch.float32) ** 2).sum()
    return total


def loss_fn(model, params: dict, obs, policy_target, value_target,
            l2_coeff: float, dropout_generator=None):
    """``(loss, TrainMetrics)`` of one batch; ``dropout_generator`` turns
    the ViT's dropout on (families without dropout ignore it)."""
    kw = ({"dropout_generator": dropout_generator}
          if isinstance(model, ViT) else {})
    logits, value = functional_call(model, params, (obs,), kw)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    policy_loss = (-policy_target * logp).sum(-1).mean()
    value_loss = ((value - value_target) ** 2).mean()
    l2 = l2_penalty(params)
    loss = policy_loss + value_loss + l2_coeff * l2
    return loss, TrainMetrics(loss, policy_loss, value_loss, l2)


def make_optimizer(cfg: TrainConfig, params: dict) -> torch.optim.Adam:
    return torch.optim.Adam(list(params.values()), lr=cfg.learning_rate)


def train_step(model, params: dict, opt, obs, policy_target, value_target,
               l2_coeff: float, dropout_generator=None) -> TrainMetrics:
    """One Adam step on one batch; ``params`` are leaf tensors that require
    grad and that ``opt`` updates in place."""
    opt.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(model, params, obs, policy_target, value_target,
                            l2_coeff, dropout_generator)
    loss.backward()
    opt.step()
    return TrainMetrics(*(m.detach() for m in metrics))


def train_epoch(model, params: dict, buffer: ReplayBuffer, cfg: TrainConfig,
                steps: int, *, generator, dropout_generator=None, syms=None,
                augment_skip: int = 0, chunk_steps: int = 32):
    """Exactly ``steps`` Adam steps from a fresh optimizer, each on a new
    replay sample drawn from ``generator``, with the dropout masks drawn
    from ``dropout_generator`` (on the parameters' device; None trains
    without dropout).  Returns the new parameters (``params`` is left as it
    was) and the metrics averaged over the last chunk of ≤ ``chunk_steps``
    steps, which is what the JAX trainer reports (its epochs run as jitted
    chunks of 32 steps and it keeps the last chunk's mean)."""
    ps = {k: v.detach().clone().requires_grad_(True)
          for k, v in params.items()}
    opt = make_optimizer(cfg, ps)
    chunk = []
    for i in range(steps):
        if i % chunk_steps == 0:
            chunk = []
        obs, pol, val = sample(buffer, cfg.batch_size, generator=generator,
                               syms=syms, augment_skip=augment_skip)
        chunk.append(train_step(model, ps, opt, obs, pol, val, cfg.l2_coeff,
                                dropout_generator))
    metrics = TrainMetrics(*(torch.stack(m).mean() for m in zip(*chunk)))
    return {k: v.detach() for k, v in ps.items()}, metrics
