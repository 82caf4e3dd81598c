"""SGD learner: Adam on replay samples.

Counterpart of the JAX package's ``training/learner.py``.  Loss = soft-target
policy cross-entropy + value MSE + ``l2_coeff`` · Σw² over every parameter
not named ``bias`` (LayerNorm and batch-norm scales and the ViT's
embeddings included, as in the JAX package).  A network's state (batch
norm's running statistics, :func:`is_state`) rides in the same dict but is
no parameter: it has no gradient, no Adam slot and no L2.  The
batch-norm tower's training forward (``ResNetBN(..., train=True)``, which
normalises by the batch's statistics) updates it in place, outside
autograd.  The network runs under autograd through
``functional_call``, in plain PyTorch: the JAX learner runs no Pallas
kernel.  The ViT trains with dropout on, its masks drawn from an explicit
``dropout_generator`` (the JAX learner's ``dropout_rng``); the dense tower
and the ResNet have no dropout and ignore it.  Adam is created fresh for
every epoch; ``torch.optim.Adam``'s defaults (β 0.9/0.999, eps 1e-8) are
optax's.  Float32 matrix products stay full float32 (PyTorch's default; no
TF32).

Under a mesh (``parallel/``) each data rank draws ``batch_size / n_data``
rows from its own ring; after ``backward()`` the gradients and the step's
metrics, flattened into one buffer, are averaged over the data group, so
every rank takes the same Adam step.  A model split over ranks (the
tensor-parallel ViT) differentiates the L2 of its own slices; its
``l2_elsewhere`` gives the L2 of the slices the other ranks hold, which
the step adds to the ``l2`` and ``loss`` it reports.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from alphazero_tpu_torch.config import TrainConfig
from alphazero_tpu_torch.data.replay import ReplayBuffer, sample
from alphazero_tpu_torch.models.resnet import ResNetBN
from alphazero_tpu_torch.models.vit import ViT
from alphazero_tpu_torch.parallel.distributed import all_reduce


class TrainMetrics(NamedTuple):
    loss: torch.Tensor
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    l2: torch.Tensor


def is_state(name: str) -> bool:
    """Whether the entry ``name`` of a parameter dict is a network's state
    (batch norm's running statistics) rather than a trained parameter."""
    return name.rsplit(".", 1)[-1] in ("running_mean", "running_var")


def l2_penalty(params: dict) -> torch.Tensor:
    """Σ w² over all parameters except those named ``bias``, and not over
    the state."""
    total = 0.0
    for name, w in params.items():
        if name.rsplit(".", 1)[-1] == "bias" or is_state(name):
            continue
        total = total + (w.to(torch.float32) ** 2).sum()
    return total


def loss_fn(model, params: dict, obs, policy_target, value_target,
            l2_coeff: float, dropout_generator=None):
    """``(loss, TrainMetrics)`` of one batch; ``dropout_generator`` turns
    the ViT's dropout on (families without dropout ignore it).  The
    batch-norm tower runs in training mode: it normalises by the batch's
    statistics and updates the state in ``params`` in place."""
    kw = ({"dropout_generator": dropout_generator}
          if isinstance(model, ViT) else
          {"train": True} if isinstance(model, ResNetBN) else {})
    logits, value = functional_call(model, params, (obs,), kw)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    policy_loss = (-policy_target * logp).sum(-1).mean()
    value_loss = ((value - value_target) ** 2).mean()
    l2 = l2_penalty(params)
    loss = policy_loss + value_loss + l2_coeff * l2
    return loss, TrainMetrics(loss, policy_loss, value_loss, l2)


def make_optimizer(cfg: TrainConfig, params: dict) -> torch.optim.Adam:
    """Adam over the parameters of ``params`` (not the state)."""
    return torch.optim.Adam([p for k, p in params.items()
                             if not is_state(k)], lr=cfg.learning_rate)


def _mesh_mean(model, params: dict, metrics: TrainMetrics, l2_coeff: float,
               mesh) -> TrainMetrics:
    """The whole model's L2 in the metrics, then the gradients and the
    metrics averaged over the data group, in one all-reduce of one flat
    buffer."""
    elsewhere = getattr(model, "l2_elsewhere", None)
    if elsewhere is not None:
        rest = elsewhere(params)
        metrics = metrics._replace(loss=metrics.loss + l2_coeff * rest,
                                   l2=metrics.l2 + rest)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params.values()]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack([m.detach() for m in metrics])])
    flat = all_reduce(flat, mesh.data_group) / mesh.n_data
    i = 0
    for p, g in zip(params.values(), grads):
        p.grad = flat[i:i + g.numel()].view_as(g)
        i += g.numel()
    return TrainMetrics(*flat[i:])


def train_step(model, params: dict, opt, obs, policy_target, value_target,
               l2_coeff: float, dropout_generator=None,
               mesh=None) -> TrainMetrics:
    """One Adam step on one batch; ``params`` are leaf tensors that require
    grad and that ``opt`` updates in place, and the state, which the
    forward updates in place.  With a mesh the batch is this rank's share
    and the step the data group's mean."""
    opt.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(model, params, obs, policy_target, value_target,
                            l2_coeff, dropout_generator)
    loss.backward()
    if mesh is not None:
        metrics = _mesh_mean(model, params, metrics, l2_coeff, mesh)
    opt.step()
    return TrainMetrics(*(m.detach() for m in metrics))


def train_chunk(model, params: dict, opt, buffer: ReplayBuffer,
                cfg: TrainConfig, steps: int, *, generator,
                dropout_generator=None, syms=None, augment_skip: int = 0,
                mesh=None) -> TrainMetrics:
    """``steps`` Adam steps of ``opt`` on ``params`` (leaf tensors it
    updates in place), each on a new replay sample of ``batch_size`` rows
    (a data rank's share under a mesh) drawn from ``generator``, with the
    dropout masks drawn from ``dropout_generator``.  Returns the metrics
    averaged over the steps."""
    rows = cfg.batch_size // (mesh.n_data if mesh is not None else 1)
    out = []
    for _ in range(steps):
        obs, pol, val = sample(buffer, rows, generator=generator, syms=syms,
                               augment_skip=augment_skip)
        out.append(train_step(model, params, opt, obs, pol, val,
                              cfg.l2_coeff, dropout_generator, mesh))
    return TrainMetrics(*(torch.stack(m).mean() for m in zip(*out)))


def leaf_copies(params: dict) -> dict:
    """Copies of ``params`` for an optimizer to own: the parameters'
    require grad, the state's do not."""
    return {k: v.detach().clone().requires_grad_(not is_state(k))
            for k, v in params.items()}


def train_epoch(model, params: dict, buffer: ReplayBuffer, cfg: TrainConfig,
                steps: int, *, generator, dropout_generator=None, syms=None,
                augment_skip: int = 0, chunk_steps: int = 32, mesh=None):
    """Exactly ``steps`` Adam steps from a fresh optimizer, in chunks of
    :func:`train_chunk` (on the parameters' device; a None
    ``dropout_generator`` trains without dropout).  Returns the new
    parameters (``params`` is left as it was) and the metrics averaged over
    the last chunk of ≤ ``chunk_steps`` steps, which is what the JAX
    trainer reports (its epochs run as jitted chunks of 32 steps and it
    keeps the last chunk's mean)."""
    ps = leaf_copies(params)
    opt = make_optimizer(cfg, ps)
    for done in range(0, steps, chunk_steps):
        metrics = train_chunk(model, ps, opt, buffer, cfg,
                              min(chunk_steps, steps - done),
                              generator=generator,
                              dropout_generator=dropout_generator, syms=syms,
                              augment_skip=augment_skip, mesh=mesh)
    return {k: v.detach() for k, v in ps.items()}, metrics
