"""Policy/value networks and evaluator adapters: the dense tower, the
convolutional ResNets (LayerNorm and AlphaZero's batch norm) and the
Vision Transformer."""

from __future__ import annotations

import math

import torch
from torch.func import functional_call

from alphazero_tpu_torch.config import ModelConfig
from alphazero_tpu_torch.models import dense, resnet, vit
from alphazero_tpu_torch.models.dense import DenseTower
from alphazero_tpu_torch.models.resnet import ResNet, ResNetBN
from alphazero_tpu_torch.models.vit import ViT
from alphazero_tpu_torch.ops.graphs import GraphCache
from alphazero_tpu_torch.ops.resnet_tower import (make_fused_apply,
                                                  supports_fused_resnet)
from alphazero_tpu_torch.utils.profiling import span


def build_model(cfg: ModelConfig, env):
    """The configured network (``"vit"``, ``"resnet"``, ``"resnet_bn"`` or
    ``"dense"``) for an env's geometry."""
    dtype = getattr(torch, cfg.compute_dtype)
    if cfg.family == "vit":
        return ViT(
            rows=env.rows, cols=env.cols, action_dim=env.action_dim,
            channels=env.feature_dim, embed_dim=cfg.embed_dim,
            patch_size=cfg.patch_size, num_heads=cfg.num_heads,
            depth=cfg.depth, dropout=cfg.dropout, dtype=dtype)
    if cfg.family == "dense":
        return DenseTower(
            rows=env.rows, cols=env.cols, action_dim=env.action_dim,
            channels_in=env.feature_dim, win_len=env.win_len,
            width=cfg.width, blocks=cfg.blocks, dtype=dtype)
    if cfg.family in ("resnet", "resnet_bn"):
        net = ResNet if cfg.family == "resnet" else ResNetBN
        return net(
            rows=env.rows, cols=env.cols, action_dim=env.action_dim,
            channels_in=env.feature_dim, channels=cfg.channels,
            blocks=cfg.blocks, dtype=dtype)
    raise ValueError(f"unknown model family {cfg.family!r}")


def init_params(model, generator: torch.Generator) -> dict:
    """Fresh parameters drawn as flax initialises them: truncated-normal
    LeCun kernels (fan-in scaling, the fan-in of a conv kernel being
    ``in·kh·kw``), zero biases, unit LayerNorm and batch-norm scales, and
    the ViT's CLS token and position embedding from an untruncated
    normal(1.0); then the network's state, its persistent float buffers
    (batch norm's running statistics), as the module made them (means 0,
    variances 1), in the same dict."""
    out = {}
    for name, p in model.named_parameters():
        if name in ("cls_token", "pos_embed"):
            w = torch.randn(p.shape, generator=generator)
            out[name] = w.to(p.device)
        elif name.endswith("bias"):
            out[name] = torch.zeros_like(p)
        elif p.dim() == 1:                  # LayerNorm scale
            out[name] = torch.ones_like(p)
        else:
            fan_in = p.numel() // p.shape[0]
            # truncated to ±2σ; 0.8796 is that truncation's standard deviation
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(p.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
            out[name] = (w * std).to(p.device)
    for name, t in model.state_dict(keep_vars=True).items():
        if name not in out and t.is_floating_point():
            out[name] = t.detach().clone()
    return out


def params_from_flax(params_np) -> dict:
    """Flax parameter tree (numpy leaves) of any family → the torch
    module's ``state_dict``."""
    if "cls_token" in params_np:
        return vit.params_from_flax(params_np)
    if "stem_ln" in params_np:
        return resnet.params_from_flax(params_np)
    return dense.params_from_flax(params_np)


class _Graph:
    """One captured forward: a static input, its static outputs, the
    replay."""

    def __init__(self, cache: GraphCache, forward, obs):
        self.obs = obs.clone(memory_format=torch.contiguous_format)

        def run():
            self.probs, self.value = forward(self.obs)

        self.replay = cache.capture(run, obs.device)

    def __call__(self, obs):
        self.obs.copy_(obs)
        self.replay()
        return self.probs.clone(), self.value.clone()


class Evaluator(GraphCache):
    """The eager evaluator ``obs (B, F, R, C) → (probs, value)`` that
    replays its forward as a CUDA graph per batch shape.

    For CUDA inputs of a model whose forward runs no collective (no
    ``runs_collectives`` attribute set, as ``parallel.TPViT`` sets it), a
    shape's ``CAPTURE_AT``-th call captures the forward
    (``ops.graphs.capture``), and later calls at that shape copy ``obs``
    into the graph's input and replay it (a ``model.graph`` span inside
    ``model.forward``).  Every other call, and every call on the CPU, runs
    the forward eagerly.  The replayed kernels are the eager ones.
    Outputs are always fresh tensors: a caller may keep them past the next
    call.  The graph reads the parameter tensors the evaluator was built
    with at their addresses (the state, batch norm's running statistics,
    among them): an in-place update of one is seen, a tensor put in its
    place in ``params`` is not.  The ``model.forward`` span carries the
    call's rows as its ``n``.  Each evaluator is its own
    :class:`~alphazero_tpu_torch.ops.graphs.GraphCache`, keyed by the
    input's shape, dtype and device; ``captures`` and ``replays`` count
    the graphs made and the calls that replayed one."""

    def __init__(self, model, params: dict):
        super().__init__()
        self.model = model
        self.params = params
        self.graphable = not getattr(model, "runs_collectives", False)

    def forward(self, obs):
        logits, value = functional_call(self.model, self.params, (obs,))
        return torch.softmax(logits, dim=-1), value

    @torch.no_grad()
    def __call__(self, obs):
        with span("model.forward", obs.shape[0]):
            graph = None
            if self.graphable and self._engages(obs):
                graph = self.lookup((tuple(obs.shape), obs.dtype, obs.device),
                                    lambda: _Graph(self, self.forward, obs))
            if graph is None:
                return self.forward(obs)
            self.replays += 1
            with span("model.graph"):
                return graph(obs)


def make_eval_fn(model, params: dict, fused_resnet: bool = False):
    """Batched evaluator ``obs (B, F, R, C) → (softmax over ALL actions,
    value)``.  There is no legality mask: illegal actions' priors are never
    selected by the search.  For the dense family ``eval_fn.dense_spec =
    (model, params)`` lets ``search.mcts.run_mcts`` dispatch to the
    whole-move search; other families search on the per-simulation
    engine.

    The eager forward is an :class:`Evaluator`: on the card it replays a
    CUDA graph per batch shape from the shape's ``CAPTURE_AT``-th call on
    (not for a model whose forward runs collectives), returns fresh copies
    of the graph's outputs, and reads the parameter tensors it was built
    with; on the CPU it runs the forward eagerly.

    ``fused_resnet`` is the opt-in of the JAX package's ``AZ_FUSED_RESNET``:
    a ``ResNet`` that ``ops.resnet_tower.supports_fused_resnet`` accepts is
    evaluated by the fused tower kernel, its weights packed once here; every
    other model keeps the eager forward."""
    if (fused_resnet and isinstance(model, ResNet)
            and supports_fused_resnet(model)):
        apply = make_fused_apply(model, model.channels, model.blocks)
        packed = apply.pack(params)

        def fused_eval_fn(obs):
            with span("model.forward", obs.shape[0]):
                logits, value = apply.apply_packed(packed, obs)
                return torch.softmax(logits, dim=-1), value

        return fused_eval_fn

    eval_fn = Evaluator(model, params)
    if isinstance(model, DenseTower):
        eval_fn.dense_spec = (model, params)
    return eval_fn


__all__ = ["DenseTower", "Evaluator", "ResNet", "ResNetBN", "ViT",
           "build_model", "init_params", "make_eval_fn", "params_from_flax"]
