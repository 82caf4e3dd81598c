"""The trainer over a mesh of ranks: ``python -m alphazero_tpu_torch train
--mesh data=N[,model=M]``.

Counterpart of the JAX package's ``training/spmd_loop.py``.  Every rank
runs this trainer on its share, with the collect → train → gate → promote
semantics of ``Trainer``:

* collect: each data rank plays ``selfplay_batch / N`` games into its own
  ring of ``G // N`` blocks (``parallel/spmd.py:make_collect_chunk``); the
  counters are global after every chunk, so every rank leaves the loop
  after the same chunk;
* train: ``Trainer.train_epoch`` with the mesh: ``global rows //
  batch_size`` steps (the rows summed over the data group), each rank
  sampling ``batch_size / N`` rows of its ring, the gradients averaged
  over the data group before every Adam step (``training/learner.py``); no
  step until every ring holds a game;
* the ViT splits over ``model`` ranks (``parallel/tensor_parallel.py``)
  when M > 1; the model ranks of one data index play the same games and
  train on the same batch;
* gate and vanilla match: every rank gathers the full parameters, rank 0
  plays the match with the gate generator and broadcasts the score, so
  every rank makes the same promote/revert decision; the gate fails while
  a ring is empty;
* the batch-norm tower (``resnet_bn``) is refused (:func:`check_family`):
  each data rank would normalise by its own share of the batch and keep
  running statistics of its own, and synchronised batch norm is not
  implemented;
* rank 0 alone prints metrics and writes ``config.json`` and checkpoints.
  A checkpoint holds the full parameters, every data rank's ring stacked
  in the JAX package's sharded layout (``data/replay.py:stack_shards``)
  and every rank's generator states; each rank restores its own.

Generators (the seeding rule of ``parallel/spmd.py``): data rank d's
self-play, sample and dropout generators are seeded with ``fold_seed(seed
+ k, d)`` for k = 1, 2, 3; the gate generator with ``seed + 4`` on every
rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from alphazero_tpu_torch.config import Config
from alphazero_tpu_torch.data.replay import (ReplayBuffer, create, shard_of,
                                             stack_shards, to_sharded)
from alphazero_tpu_torch.eval.arena import Agent, compare
from alphazero_tpu_torch.parallel.distributed import (all_gather,
                                                      all_reduce, barrier,
                                                      broadcast,
                                                      process_info)
from alphazero_tpu_torch.parallel.mesh import (Mesh, gather_vit_params,
                                               make_mesh, shard_vit_params)
from alphazero_tpu_torch.parallel.spmd import (buffer_ready, fold_seed,
                                               make_collect_chunk, rank_state,
                                               uses_tensor_parallel)
from alphazero_tpu_torch.parallel.tensor_parallel import TPViT
from alphazero_tpu_torch.training import learner
from alphazero_tpu_torch.training.loop import Trainer
from alphazero_tpu_torch.utils.metrics import MetricsLogger

GENERATORS = ("generator", "dropout_generator", "gate_generator")


def check_family(cfg: Config):
    """Raise ``ValueError`` for a network the mesh does not train."""
    if cfg.model.family == "resnet_bn":
        raise ValueError(
            "--mesh does not train the batch-norm tower (model family "
            "'resnet_bn'): each data rank would normalise by its own share "
            "of the batch and keep running statistics of its own; "
            "synchronised batch norm across ranks is not implemented")


class SpmdTrainer(Trainer):
    """``Trainer`` on one rank of ``mesh`` (default: every rank of the
    process group, ``model=cfg.mesh.model_parallel``).  ``device`` defaults
    to the rank's card (``parallel.distributed.initialize``), or the GPU
    without a process group; without CUDA the constructor raises unless
    ``device="cpu"`` is passed.  The default logger prints on rank 0
    only, and so does ``display``."""

    def __init__(self, cfg: Config, mesh: Optional[Mesh] = None,
                 device=None, workdir: Optional[str] = None,
                 logger: Optional[MetricsLogger] = None,
                 display: bool = False, fused_resnet: bool = False):
        check_family(cfg)
        self.mesh = mesh = mesh or make_mesh(n_model=cfg.mesh.model_parallel)
        n = mesh.n_data
        for what, size in (("selfplay_batch", cfg.train.selfplay_batch),
                           ("batch_size", cfg.train.batch_size)):
            if size % n:
                raise ValueError(f"{what} {size} must divide over data={n} "
                                 f"ranks")
        self.tensor_parallel = uses_tensor_parallel(cfg, mesh)
        rank0 = mesh.rank == 0
        super().__init__(cfg, device or process_info()["device"] or "cuda",
                         workdir,
                         logger or MetricsLogger(stdout=rank0),
                         display, persist_config=rank0,
                         fused_resnet=fused_resnet)
        self._net = (TPViT(self.model, mesh) if self.tensor_parallel
                     else self.model)
        dev, seed, d = self.device, cfg.train.seed, mesh.data_index
        self.generator.manual_seed(fold_seed(seed + 2, d))
        self.dropout_generator.manual_seed(fold_seed(seed + 3, d))
        self.gate_generator = torch.Generator(device=dev).manual_seed(
            seed + 4)

    def _initial_state(self, params: dict):
        return rank_state(self.env, self.cfg, self.mesh, params, self.device)

    def _make_runner(self):
        return make_collect_chunk(self.env, self.model, self.cfg, self.mesh,
                                  self._chunk_steps, self.fused_resnet)

    # ------------------------------------------------------------- phases
    # collect() is inherited: self._runner is the mesh's collect chunk, and
    # with display every rank leaves the loop by the same rule

    def _show_game0(self):
        if self.mesh.rank == 0:
            super()._show_game0()

    def _buffer_rows(self) -> int:
        """The data group's buffer rows (symmetry orbits counted)."""
        rows = torch.tensor([super()._buffer_rows()], dtype=torch.int64,
                            device=self.device)
        return int(all_reduce(rows, self.mesh.data_group))

    def train_epoch(self) -> dict:
        """``Trainer.train_epoch`` over the mesh (each step's gradients
        averaged over the data group), once every ring holds a game; until
        then no step (``trained`` False, ``steps`` 0).  The rings do not
        change during an epoch, so one check decides it."""
        if buffer_ready(self.buffer, self.mesh):
            return super().train_epoch()
        zero = torch.zeros(())
        return self._log_train(0, learner.TrainMetrics(zero, zero, zero,
                                                       zero),
                               time.perf_counter())

    def _learner_net(self):
        return self._net

    def _log_train(self, steps: int, metrics, t0: float) -> dict:
        return super()._log_train(steps, metrics, t0, trained=steps > 0)

    def gate(self) -> float:
        """The contender against the best on the full parameters; a
        contender that never trained (a ring still empty) fails."""
        if not buffer_ready(self.buffer, self.mesh):
            return 0.0 if self.cfg.train.gate_enabled else 1.0
        return super().gate()

    def _full(self, params: dict) -> dict:
        return (gather_vit_params(params, self.mesh) if self.tensor_parallel
                else params)

    def _eval_fn(self, params):
        return super()._eval_fn(self._full(params))

    def _compare(self, best: Agent, contender: Agent, games: int, **kw):
        """The match on rank 0 with the gate generator; its score goes to
        every rank."""
        score = torch.zeros(3, dtype=torch.float64)
        if self.mesh.rank == 0:
            _, s = compare(self.env, best, contender, games,
                           generator=self.gate_generator, device=self.device,
                           **kw)
            score = torch.as_tensor(s, dtype=torch.float64)
        score = broadcast(score.to(self.device)).cpu().numpy()
        return float(score[1] / games), score

    def expand_depth(self, new_depth: int):
        raise NotImplementedError(
            "--expand-depth under --mesh is not supported; expand in a "
            "single process, checkpoint, then resume with --mesh")

    # ---------------------------------------------------------- checkpoint
    def _state(self) -> dict:
        """The run's whole state on every rank (collectives: every rank
        calls it): full parameters, the rings stacked, every rank's
        generator states stacked by rank."""
        fields = [f.name for f in dataclasses.fields(ReplayBuffer)]
        parts = [all_gather(getattr(self.buffer, k), self.mesh.data_group)
                 for k in fields]
        rings = stack_shards([ReplayBuffer(*ring) for ring in zip(*parts)])
        gens = {name: torch.stack(all_gather(
            getattr(self, name).get_state().to(self.device), None))
            for name in GENERATORS}
        return {"params_best": self._full(self.params_best),
                "params_new": self._full(self.params_new),
                "buffer": {k: getattr(rings, k) for k in fields}, **gens,
                "version": torch.tensor(self.version),
                "outer_iter": torch.tensor(self.outer_iter)}

    def save_checkpoint(self):
        """Every rank gathers the state; rank 0 writes it."""
        if not self._ckpt:
            return
        state = self._state()
        if self.mesh.rank == 0:
            self._ckpt.save(self.version, state)
        barrier()

    def _load_state(self, state: dict):
        m, dev = self.mesh, self.device
        for key in ("params_best", "params_new"):
            p = {k: v.to(dev) for k, v in state[key].items()}
            setattr(self, key, shard_vit_params(p, m)
                    if self.tensor_parallel else p)
        ring = shard_of(ReplayBuffer(**state["buffer"]), m.data_index)
        self.buffer = ReplayBuffer(**{f.name: getattr(ring, f.name).to(dev)
                                      for f in dataclasses.fields(ring)})
        for name in GENERATORS:
            getattr(self, name).set_state(state[name][m.rank].clone())
        self.version = int(state["version"])
        self.outer_iter = int(state["outer_iter"])

    def import_buffer(self, workdir: str, step: Optional[int] = None) -> int:
        """``Trainer.import_buffer`` into a flat buffer of the run's whole
        capacity, split as ``to_sharded`` splits it; this rank keeps its
        ring."""
        self.buffer = create(self.env, self.cfg.replay.capacity, self.device)
        k = super().import_buffer(workdir, step)
        self.buffer = shard_of(to_sharded(self.buffer, self.mesh.n_data),
                               self.mesh.data_index)
        return k
