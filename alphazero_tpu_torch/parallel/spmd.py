"""The programs of a mesh run: collect, train and both in one step.

Counterpart of the JAX package's ``parallel/spmd.py``.  JAX compiles one
SPMD program over the mesh and lets XLA place the collectives; here every
rank runs these functions on its own slice and calls the collectives
itself, in the same order on every rank:

* :func:`make_sharded_selfplay`: each data rank runs the whole-chunk
  search (``selfplay_chunk``, the chunk kernels) on its slice of the game
  batch into its own ring; the chunk's game, step and result counts are
  then summed over the data group (JAX's ``psum``s), so every rank holds
  the global counters;
* :func:`make_collect_chunk`: that, or, for every other network (and a
  tensor-parallel ViT), ``num_steps`` moves of ``selfplay_step`` with the
  same counter sum;
* :func:`buffer_ready`: the warm-up gate, true once every rank's ring
  holds a game (a MIN over the ranks);
* :func:`make_train_chunk`: the data-parallel learner
  (``training/learner.py`` with a mesh) behind the warm-up gate;
* :func:`make_super_step`: one collect and one fresh-Adam train in one
  call;
* :func:`rank_state`, the placement JAX's ``shardings_for`` /
  ``jit_super_step`` make: this rank's parameter slices, its games and its
  ring.

Seeding rule.  Every rank draws the same initial parameters.  A data
rank's self-play, replay-sample and dropout generators are seeded with
:func:`fold_seed` ``(seed, data_index)`` (the JAX package folds the shard
index into its key), so data ranks draw apart and the model ranks of one
data index draw alike: they play the same games and take the same batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from alphazero_tpu_torch.config import Config
from alphazero_tpu_torch.data.augment import Symmetries
from alphazero_tpu_torch.data.replay import ReplayBuffer, create_ring
from alphazero_tpu_torch.parallel.distributed import all_reduce
from alphazero_tpu_torch.parallel.mesh import Mesh, shard_vit_params
from alphazero_tpu_torch.parallel.tensor_parallel import TPViT
from alphazero_tpu_torch.search.fused import supports_chunk
from alphazero_tpu_torch.training import learner
from alphazero_tpu_torch.training.selfplay import (SelfPlayState,
                                                   init_selfplay,
                                                   make_selfplay_runner,
                                                   selfplay_chunk)


def fold_seed(seed: int, index: int) -> int:
    """The seed of data rank ``index``'s generator for base ``seed``
    (index 0 keeps ``seed``)."""
    return seed + (index << 16)


def uses_tensor_parallel(cfg: Config, mesh: Mesh) -> bool:
    """A ViT splits over ``model`` ranks; other families replicate."""
    return cfg.model.family == "vit" and mesh.n_model > 1


def _global_counters(run, mesh: Mesh):
    """``run`` followed by the sum of its counter increments over the data
    group, in one all-reduce."""
    def run_global(params, sp: SelfPlayState, buffer: ReplayBuffer):
        g0, e0, r0 = sp.games_done, sp.env_steps, sp.results
        sp, buffer = run(params, sp, buffer)
        delta = torch.cat([(sp.games_done - g0)[None],
                           (sp.env_steps - e0)[None], sp.results - r0])
        all_reduce(delta, mesh.data_group)
        return dataclasses.replace(
            sp, games_done=g0 + delta[0], env_steps=e0 + delta[1],
            results=r0 + delta[2:]), buffer
    return run_global


def make_sharded_selfplay(env, model, cfg: Config, mesh: Mesh,
                          num_steps: int, evaluator=None) -> Callable:
    """``run(params, sp, buffer) -> (sp, buffer)``: ``num_steps`` moves of
    this rank's games through the whole-chunk search into this rank's
    ring, with global counters.  ``evaluator`` replaces the network (the
    tests' exact stub)."""
    def run(params, sp, buffer):
        return selfplay_chunk(env, model, params, cfg.mcts, cfg.replay, sp,
                              buffer, num_steps, evaluator=evaluator)
    return _global_counters(run, mesh)


def make_collect_chunk(env, model, cfg: Config, mesh: Mesh, num_steps: int,
                       fused_resnet: bool = False) -> Callable:
    """The actor phase: ``collect(params, sp, buffer) -> (sp, buffer)``:
    :func:`make_sharded_selfplay` where ``supports_chunk`` takes the
    network, else ``num_steps`` moves of ``selfplay_step`` (a ``TPViT`` of
    ``model`` under tensor parallelism), with global counters."""
    tensor_parallel = uses_tensor_parallel(cfg, mesh)
    if not tensor_parallel and supports_chunk(env, model, cfg.mcts):
        return make_sharded_selfplay(env, model, cfg, mesh, num_steps)
    net = TPViT(model, mesh) if tensor_parallel else model
    return _global_counters(
        make_selfplay_runner(env, net, cfg.mcts, cfg.replay, num_steps,
                             fused_resnet), mesh)


def buffer_ready(buffer: ReplayBuffer, mesh: Mesh) -> bool:
    """The warm-up gate: True once every rank's ring holds a game (a MIN
    over all ranks, so every rank gets the same answer)."""
    ready = (buffer.size > 0).to(torch.int32).reshape(1)
    return bool(all_reduce(ready, None, dist.ReduceOp.MIN))


def make_train_chunk(env, model, cfg: Config, mesh: Mesh, num_steps: int,
                     device="cuda") -> Callable:
    """The learner phase: ``train(params, opt, buffer, generator,
    dropout_generator, num_active) -> (metrics, trained)`` runs ``num_active``
    ≤ ``num_steps`` data-parallel Adam steps of ``opt`` on ``params`` (leaf
    tensors it updates in place; one optimizer for a whole epoch keeps the
    epoch's fresh Adam), each on this rank's share of ``batch_size``, and
    returns their mean metrics.  Until :func:`buffer_ready` it takes no
    step and returns zero metrics and ``trained`` False."""
    net = TPViT(model, mesh) if uses_tensor_parallel(cfg, mesh) else model
    syms = Symmetries(env, device) if cfg.replay.augment else None

    def train(params, opt, buffer, generator, dropout_generator,
              num_active: int = num_steps):
        if not buffer_ready(buffer, mesh):
            zero = torch.zeros((), device=buffer.size.device)
            return learner.TrainMetrics(zero, zero, zero, zero), False
        metrics = learner.train_chunk(
            net, params, opt, buffer, cfg.train, min(num_active, num_steps),
            generator=generator, dropout_generator=dropout_generator,
            syms=syms, augment_skip=cfg.replay.augment_skip_moves, mesh=mesh)
        return metrics, True

    return train


def make_super_step(env, model, cfg: Config, mesh: Mesh,
                    selfplay_steps: int, train_steps: int,
                    fused_resnet: bool = False, device="cuda") -> Callable:
    """``super_step(params, sp, buffer, generator, dropout_generator) ->
    (params, sp, buffer, metrics)``: ``selfplay_steps`` moves of
    :func:`make_collect_chunk`, then ``train_steps`` steps of
    :func:`make_train_chunk` from a fresh Adam (no step while a ring is
    empty)."""
    collect = make_collect_chunk(env, model, cfg, mesh, selfplay_steps,
                                 fused_resnet)
    train = make_train_chunk(env, model, cfg, mesh, train_steps, device)

    def super_step(params, sp, buffer, generator, dropout_generator):
        sp, buffer = collect(params, sp, buffer)
        ps = learner.leaf_copies(params)
        metrics, _ = train(ps, learner.make_optimizer(cfg.train, ps), buffer,
                           generator, dropout_generator)
        return {k: v.detach() for k, v in ps.items()}, sp, buffer, metrics

    return super_step


def init_rank_selfplay(env, batch_size: int, seed: int, mesh: Mesh,
                       device="cuda") -> SelfPlayState:
    """This data rank's ``batch_size / n_data`` fresh games, its generator
    seeded with :func:`fold_seed` ``(seed, data_index)``: the rank's slice
    of ``init_selfplay(env, batch_size, ...)``, whose games all start
    alike, made alone."""
    return init_selfplay(env, batch_size // mesh.n_data,
                         fold_seed(seed, mesh.data_index), device)


def rank_state(env, cfg: Config, mesh: Mesh, params: dict, device="cuda"):
    """This rank's starting state, where JAX's ``shardings_for`` places
    the replicated one: the parameters (its ViT slices under tensor
    parallelism), its games (:func:`init_rank_selfplay` with the self-play
    seed ``seed + 1``) and its empty ring (``create_ring``)."""
    if uses_tensor_parallel(cfg, mesh):
        params = shard_vit_params(params, mesh)
    t = cfg.train
    return (params, init_rank_selfplay(env, t.selfplay_batch, t.seed + 1,
                                       mesh, device),
            create_ring(env, cfg.replay.capacity, mesh.n_data, device))
