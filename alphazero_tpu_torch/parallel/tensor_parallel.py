"""The ViT split over the mesh's ``model`` ranks (Megatron's layout).

Counterpart of what XLA builds from the JAX package's
``vit_param_sharding``: each of M model ranks holds ``H/M`` heads of every
attention block and ``4E/M`` of its MLP's hidden units (``parallel/mesh.py``
says which rows and columns).  Two conjugate operators join the slices:

* :func:`copy_to_model`, identity forward and a sum over the model group
  backward, in front of the column-split projections (query, key, value
  and ``mlp_fc1``), whose input every rank holds whole;
* :func:`reduce_from_model`, a sum over the model group forward and
  identity backward, after the row-split ones (``out`` and ``mlp_fc2``),
  whose partial products add up to the replicated result; their biases
  are added once, after it.

(``torch.distributed.nn.functional.all_reduce`` will not do for the second:
its backward sums again.)  The sums run in float32 and round to the
compute dtype once.  Dropout draws the replicated model's masks: the
``(T, T)`` attention mask and the block output's mask whole on every rank,
the hidden units' mask at full width ``4E`` with each rank keeping its
slice, so model ranks that share a generator state draw what one
replicated model would.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from alphazero_tpu_torch.models.dense import LN_EPS
from alphazero_tpu_torch.models.vit import (ViT, Attention, AttentionBlock,
                                            _attend, _dropout, _keep_mask,
                                            _keep_rate, _linear, _ln)
from alphazero_tpu_torch.parallel.distributed import all_reduce
from alphazero_tpu_torch.parallel.mesh import vit_split_dim


def _sum(x, group):
    y = x.to(torch.float32, copy=True)
    return all_reduce(y, group).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x, group):
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return _ReduceFromModel.apply(x, group)


class TPAttention(Attention):
    """This rank's heads: query/key/value ``Linear(E, E/M)``, out
    ``Linear(E/M, E)``."""

    def __init__(self, embed_dim, num_heads, dropout, mesh):
        nn.Module.__init__(self)
        M = mesh.n_model
        self.head_dim = embed_dim // num_heads
        self.num_heads = num_heads // M
        self.dropout = dropout
        self.group = mesh.model_group
        for name in ("query", "key", "value"):
            self.add_module(name, nn.Linear(embed_dim, embed_dim // M))
        self.out = nn.Linear(embed_dim // M, embed_dim)

    def forward(self, x, dtype, generator=None):
        B, T, _ = x.shape
        y = _attend(self, copy_to_model(x, self.group), self.head_dim, dtype,
                    generator).reshape(B, T, -1)
        y = reduce_from_model(F.linear(y, self.out.weight.to(dtype)),
                              self.group)
        return y + self.out.bias.to(dtype)


class TPBlock(AttentionBlock):
    def __init__(self, embed_dim, num_heads, dropout, mesh):
        nn.Module.__init__(self)
        M = mesh.n_model
        self.dropout = dropout
        self.group, self.n_model, self.index = (mesh.model_group, M,
                                                mesh.model_index)
        self.norm1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.attn = TPAttention(embed_dim, num_heads, dropout, mesh)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(embed_dim, 4 * embed_dim // M)
        self.mlp_fc2 = nn.Linear(4 * embed_dim // M, embed_dim)

    def forward(self, x, dtype, generator=None):
        x = x + self.attn(_ln(x, self.norm1, dtype), dtype, generator)
        h = copy_to_model(_ln(x, self.norm2, dtype), self.group)
        y = F.gelu(_linear(h, self.mlp_fc1, dtype))
        if generator is not None and self.dropout > 0.0:
            w = y.shape[-1]
            keep = _keep_mask(y.shape[:-1] + (w * self.n_model,),
                              self.dropout, generator, y.device)
            keep = keep[..., self.index * w:(self.index + 1) * w]
            y = torch.where(keep, y / _keep_rate(self.dropout, y.dtype),
                            torch.zeros_like(y))
        y = reduce_from_model(F.linear(y, self.mlp_fc2.weight.to(dtype)),
                              self.group) + self.mlp_fc2.bias.to(dtype)
        return x + _dropout(y, self.dropout, generator)


class TPViT(ViT):
    """``model``'s architecture with every block split over ``mesh``'s
    model ranks; its parameters are this rank's slices
    (``parallel.mesh.shard_vit_params``), passed in as the replicated
    model's are (``functional_call``).  Its forward all-reduces over the
    model group, so ``models.Evaluator`` never captures it in a CUDA
    graph (``runs_collectives``)."""

    runs_collectives = True

    def __init__(self, model: ViT, mesh):
        M = mesh.n_model
        if model.num_heads % M:
            raise ValueError(f"{model.num_heads} heads do not split over "
                             f"model={M}")
        super().__init__(model.rows, model.cols, model.action_dim,
                         model.channels, model.embed_dim, model.patch_size,
                         model.num_heads, model.depth, model.dropout,
                         model.dtype)
        self.group = mesh.model_group
        for i in range(model.depth):
            self.add_module(f"block_{i}", TPBlock(
                model.embed_dim, model.num_heads, model.dropout, mesh))

    def l2_elsewhere(self, params: dict) -> torch.Tensor:
        """Σ w² of the split weights the other model ranks hold (one sum
        over the model group; biases excluded, as the learner's L2 excludes
        them): what the learner adds to this rank's L2 to report the whole
        model's.  No gradient flows through it."""
        local = sum((w.detach().to(torch.float32) ** 2).sum()
                    for name, w in params.items()
                    if vit_split_dim(name) is not None
                    and name.rsplit(".", 1)[-1] != "bias")
        return all_reduce(local.clone(), self.group) - local
