"""The outer training loop: collect → train → gate → promote.

Counterpart of the JAX package's ``training/loop.py``.  The best parameters
generate the self-play data; the contender (``params_new``, a copy of the
best) trains on it; the gate plays contender against best and promotes the
contender when its win rate exceeds ``gate_threshold``, else reverts it.
Collection doubles after ``reject_double_after`` rejections in a row, and
every ``vanilla_eval_every`` promotions the best parameters play a sanity
match against vanilla (rollout) search.  Any ported family trains: the
dense tower collects through the whole-chunk search, the ResNet move by
move on the per-simulation engine.  Checkpoints, the metrics logger and
``config.json`` are module 9 of ROADMAP.md and are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from alphazero_tpu_torch.config import Config
from alphazero_tpu_torch.data.augment import Symmetries
from alphazero_tpu_torch.data.replay import create, num_rows_augmented
from alphazero_tpu_torch.device import resolve_device
from alphazero_tpu_torch.envs import make_env
from alphazero_tpu_torch.eval.arena import Agent, compare
from alphazero_tpu_torch.models import build_model, init_params, make_eval_fn
from alphazero_tpu_torch.training import learner
from alphazero_tpu_torch.training.selfplay import (init_selfplay,
                                                   make_selfplay_runner)

SELFPLAY_CHUNK_STEPS = 32
TRAIN_CHUNK_STEPS = 32


def _copy(params: dict) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}


class Trainer:
    """Single-device trainer.  ``device`` defaults to the GPU; without CUDA
    the constructor raises unless ``device="cpu"`` is passed."""

    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.env = make_env(cfg.env)
        self.model = build_model(cfg.model, self.env).to(self.device)
        gen = torch.Generator().manual_seed(cfg.train.seed)
        # best ("older") generates data; the contender ("newer") trains
        self.params_best = {k: v.to(self.device)
                            for k, v in init_params(self.model, gen).items()}
        self.params_new = _copy(self.params_best)
        self.buffer = create(self.env, cfg.replay.capacity, self.device)
        self.sp = init_selfplay(self.env, cfg.train.selfplay_batch,
                                cfg.train.seed + 1, self.device)
        # draws of the learner's samples and of the gate's matches
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed + 2)
        self.version = 0
        self.outer_iter = 0
        self.reject_count = 0
        self.last_gate_score = None     # [best, contender, draws]
        self.last_vanilla_score = None  # [vanilla, model, draws]
        self._syms = Symmetries(self.env, self.device)
        self._chunk_steps = (cfg.train.selfplay_chunk_steps
                             or SELFPLAY_CHUNK_STEPS)
        self._runner = make_selfplay_runner(self.env, self.model, cfg.mcts,
                                            cfg.replay, self._chunk_steps)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- phases
    def collect(self, games_target: int) -> dict:
        """Self-play with the best params until ``games_target`` new games
        finish.

        As in the JAX trainer, the loop reads the game counter from before
        the chunk it just ran, so it plays at most one chunk past the
        target.  Each chunk ends in a device synchronisation, and its
        seconds are reported in ``chunk_seconds``."""
        start_games = int(self.sp.games_done)
        start_steps = int(self.sp.env_steps)
        chunk_seconds = []
        t0 = time.perf_counter()
        while True:
            done_prev = self.sp.games_done
            tc = time.perf_counter()
            self.sp, self.buffer = self._runner(self.params_best, self.sp,
                                                self.buffer)
            self._sync()
            chunk_seconds.append(time.perf_counter() - tc)
            if int(done_prev) - start_games >= games_target:
                break
        dt = time.perf_counter() - t0
        steps = int(self.sp.env_steps) - start_steps
        return {
            "games": int(self.sp.games_done) - start_games,
            "env_steps": steps,
            "env_steps_per_s": steps / max(dt, 1e-9),
            "sims_per_s": steps * self.cfg.mcts.num_simulations / max(dt, 1e-9),
            "buffer_size": self._buffer_rows(),
            "results": self.sp.results.tolist(),
            "seconds": dt,
            "chunk_seconds": chunk_seconds,
        }

    def _buffer_rows(self) -> int:
        """Buffer occupancy in augmented rows (symmetry orbits counted)."""
        n_syms = self._syms.num if self.cfg.replay.augment else 1
        return int(num_rows_augmented(self.buffer, n_syms,
                                      self.cfg.replay.augment_skip_moves))

    def train_epoch(self) -> dict:
        """SGD on the contender: ``buffer rows // batch`` steps (at least 1)
        unless ``train_steps_per_iter`` is set, from a fresh Adam state.
        The losses reported are the last chunk's mean, as the JAX trainer
        reports them."""
        t = self.cfg.train
        steps = max(self._buffer_rows() // t.batch_size, 1)
        if t.train_steps_per_iter is not None:
            steps = t.train_steps_per_iter
        t0 = time.perf_counter()
        self.params_new, metrics = learner.train_epoch(
            self.model, self.params_new, self.buffer, t, steps,
            generator=self.generator,
            syms=self._syms if self.cfg.replay.augment else None,
            augment_skip=self.cfg.replay.augment_skip_moves,
            chunk_steps=TRAIN_CHUNK_STEPS)
        m = {k: float(v) for k, v in metrics._asdict().items()}
        return {"steps": steps, **m, "seconds": time.perf_counter() - t0}

    def gate(self) -> float:
        """Contender-vs-best arena of ``gate_games`` games with visit
        sampling → the contender's win rate; 1.0 when the gate is disabled."""
        if not self.cfg.train.gate_enabled:
            return 1.0
        best = Agent(make_eval_fn(self.model, self.params_best), self.cfg.mcts)
        cont = Agent(make_eval_fn(self.model, self.params_new), self.cfg.mcts)
        rate, score = compare(self.env, best, cont, self.cfg.train.gate_games,
                              generator=self.generator, sampling=True,
                              device=self.device)
        self.last_gate_score = score.tolist()
        return rate

    def vanilla_sanity_match(self, games: int = 2) -> float:
        """The best parameters against vanilla search with
        ``min(num_simulations · max(version, 1), 400)`` rollout simulations
        → the model's win rate (draws 0.5); the score is kept in
        ``last_vanilla_score`` as [vanilla, model, draws]."""
        sims = min(self.cfg.mcts.num_simulations * max(self.version, 1), 400)
        vanilla = Agent(None, dataclasses.replace(self.cfg.mcts,
                                                  num_simulations=sims))
        model = Agent(make_eval_fn(self.model, self.params_best),
                      self.cfg.mcts)
        rate, score = compare(self.env, vanilla, model, games,
                              generator=self.generator, device=self.device)
        self.last_vanilla_score = score.tolist()
        return rate

    # ------------------------------------------------------------ iteration
    def iterate(self, vanilla_eval: bool = True) -> dict:
        """One outer iteration.  With ``vanilla_eval``, a promotion that
        brings ``version`` to a multiple of ``vanilla_eval_every`` is
        followed by :meth:`vanilla_sanity_match`, whose rate the result
        holds as ``vanilla_win_rate``."""
        t = self.cfg.train
        self.outer_iter += 1
        games = t.games_per_iter
        if self.reject_count >= t.reject_double_after:
            games *= 2
        cm = self.collect(games)
        tm = self.train_epoch()
        t0 = time.perf_counter()
        rate = self.gate()
        self._sync()
        gate_seconds = time.perf_counter() - t0
        accepted = rate > t.gate_threshold
        extra = {}
        if accepted:
            self.params_best = _copy(self.params_new)
            self.version += 1
            self.reject_count = 0
            if vanilla_eval and self.version % t.vanilla_eval_every == 0:
                extra["vanilla_win_rate"] = self.vanilla_sanity_match()
        else:
            self.params_new = _copy(self.params_best)
            self.reject_count += 1
        return {"iter": self.outer_iter, "version": self.version,
                "accepted": bool(accepted), "gate_rate": rate, **cm, **tm,
                "collect_seconds": cm["seconds"],
                "train_seconds": tm["seconds"], "gate_seconds": gate_seconds,
                **extra}

    def run(self, iterations=None, vanilla_eval: bool = True):
        n = iterations or self.cfg.train.outer_iterations
        for _ in range(n):
            self.iterate(vanilla_eval=vanilla_eval)
