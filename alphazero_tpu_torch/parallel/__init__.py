"""Multi-process training: the mesh of ranks, the tensor-parallel ViT and
the programs of a mesh run (the JAX package's ``parallel/``).

The programs (``parallel.spmd``) are loaded on first use: they import the
learner, which imports this package's collectives.
"""

from alphazero_tpu_torch.parallel.distributed import (initialize, launch,
                                                      process_info)
from alphazero_tpu_torch.parallel.mesh import (Mesh, gather_vit_params,
                                               make_mesh, shard_vit_params)
from alphazero_tpu_torch.parallel.tensor_parallel import TPViT

_SPMD = ("buffer_ready", "make_collect_chunk", "make_sharded_selfplay",
         "make_super_step", "make_train_chunk", "rank_state")


def __getattr__(name):
    if name in _SPMD:
        from alphazero_tpu_torch.parallel import spmd
        return getattr(spmd, name)
    raise AttributeError(name)


__all__ = ["Mesh", "TPViT", "gather_vit_params", "initialize", "launch",
           "make_mesh", "process_info", "shard_vit_params", *_SPMD]
