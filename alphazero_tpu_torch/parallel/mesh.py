"""The ``(data, model)`` mesh of ranks and the ViT's tensor-parallel split.

Counterpart of the JAX package's ``parallel/mesh.py``.  JAX lays a device
grid ``(n_data, n_model)`` out row-major; here the grid is of ranks: rank
``r`` sits at ``(r // n_model, r % n_model)``.  The self-play games, the
replay rings and the learner's batch split over ``data``; a ViT splits its
heads and MLP hidden units over ``model``.  A rank's data group is the
ranks with its model index (they hold the same parameter slices and
all-reduce their gradients), its model group the ranks with its data index
(they play the same games and hold the slices of one model).

The ViT's split follows ``vit_param_sharding``: the query, key and value
projections by output rows (whole heads: ``nn.Linear(E, E)`` rows
``[i·E/M, (i+1)·E/M)`` are heads ``[i·H/M, (i+1)·H/M)``), with their
biases; the attention's ``out`` by input columns; ``mlp_fc1`` by rows and
bias; ``mlp_fc2`` by columns; everything else replicated (the biases of
``out`` and ``mlp_fc2`` too: they are added once, after the reduction).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from alphazero_tpu_torch.parallel.distributed import all_gather

# parameter name suffix → the dimension the ViT splits over 'model'
VIT_SPLIT = {"attn.query.weight": 0, "attn.query.bias": 0,
             "attn.key.weight": 0, "attn.key.bias": 0,
             "attn.value.weight": 0, "attn.value.bias": 0,
             "attn.out.weight": 1,
             "mlp_fc1.weight": 0, "mlp_fc1.bias": 0,
             "mlp_fc2.weight": 1}


def vit_split_dim(name: str) -> Optional[int]:
    """The dimension parameter ``name`` of a ViT splits over, or None
    (replicated)."""
    return VIT_SPLIT.get(name.split(".", 1)[-1])


@dataclasses.dataclass
class Mesh:
    n_data: int
    n_model: int
    rank: int
    data_index: int
    model_index: int
    data_group: object      # process group of the ranks of this model index
    model_group: object     # process group of the ranks of this data index

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The mesh over the process group's ranks (``n_data`` defaults to
    world // n_model).  Every rank must call it, in the same order as its
    other collectives.  Without a process group only a 1 × 1 mesh exists."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a data={n_data}, model={n_model} mesh needs "
                         f"{n_data * n_model} ranks; this run has {world}")
    groups = {}
    if dist.is_initialized():
        # every rank creates every group, in one order
        for m in range(n_model):
            groups["data", m] = dist.new_group(
                [d * n_model + m for d in range(n_data)])
        for d in range(n_data):
            groups["model", d] = dist.new_group(
                [d * n_model + m for m in range(n_model)])
    d, m = divmod(rank, n_model)
    return Mesh(n_data, n_model, rank, d, m, groups.get(("data", m)),
                groups.get(("model", d)))


def shard_vit_params(params: dict, mesh: Mesh) -> dict:
    """This rank's slices of full ViT parameters (replicated ones as
    they are)."""
    out = {}
    for name, w in params.items():
        dim = vit_split_dim(name)
        out[name] = (w if dim is None else
                     w.chunk(mesh.n_model, dim)[mesh.model_index].clone())
    return out


def gather_vit_params(params: dict, mesh: Mesh) -> dict:
    """Full ViT parameters from every model rank's slices, on each rank
    and on the slices' device."""
    out = {}
    for name, w in params.items():
        dim = vit_split_dim(name)
        out[name] = w if dim is None else torch.cat(
            all_gather(w, mesh.model_group), dim).to(w.device)
    return out
