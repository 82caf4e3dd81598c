"""The outer training loop: collect → train → gate → promote.

Counterpart of the JAX package's ``training/loop.py``.  The best parameters
generate the self-play data; the contender (``params_new``, a copy of the
best) trains on it; the gate plays contender against best and promotes the
contender when its win rate exceeds ``gate_threshold``, else reverts it.
Collection doubles after ``reject_double_after`` rejections in a row, and
every ``vanilla_eval_every`` promotions the best parameters play a sanity
match against vanilla (rollout) search.  Every family trains: the dense
tower collects through the whole-chunk search, the ResNet and the ViT move
by move on the per-simulation engine (the LayerNorm ResNet's forward the
fused tower kernel with ``fused_resnet``; the learner keeps the module
forward, the ViT's with dropout on, the batch-norm ResNet's with the
batch's statistics).  A network's state (batch norm's running statistics)
is part of each parameter dict: it rides in ``params_best`` and
``params_new``, their copies, the gate's agents and the checkpoints.
:meth:`Trainer.expand_depth` grows a ViT's depth in place.  Every phase
logs a JSON-line record (``collect``, ``train``, ``gate``, ``vanilla_eval``,
``iteration``, with the JAX package's field names); with a ``workdir`` the
run's ``config.json`` is written there and every promotion saves a
checkpoint (``utils/checkpoint.py``) of both parameter sets, the replay
buffer, the generators of the learner's samples and the gate's draws and of
the learner's dropout, ``version`` and ``outer_iter``, what the JAX package
saves (its one RNG key stands for both generators).  Neither package saves
the self-play state.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from alphazero_tpu_torch.config import Config, save_config
from alphazero_tpu_torch.data.augment import Symmetries
from alphazero_tpu_torch.data.replay import (ReplayBuffer, create,
                                             num_rows_augmented)
from alphazero_tpu_torch.device import resolve_device
from alphazero_tpu_torch.envs import make_env
from alphazero_tpu_torch.eval.arena import Agent, compare
from alphazero_tpu_torch.models import build_model, init_params, make_eval_fn
from alphazero_tpu_torch.models.surgery import expand_vit_depth
from alphazero_tpu_torch.training import learner
from alphazero_tpu_torch.training.selfplay import (init_selfplay,
                                                   make_selfplay_runner)
from alphazero_tpu_torch.utils.checkpoint import CheckpointManager
from alphazero_tpu_torch.utils.metrics import MetricsLogger
from alphazero_tpu_torch.utils.profiling import span

SELFPLAY_CHUNK_STEPS = 32
TRAIN_CHUNK_STEPS = 32


def _copy(params: dict) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}


class Trainer:
    """Single-device trainer.  ``device`` defaults to the GPU; without CUDA
    the constructor raises unless ``device="cpu"`` is passed.  ``logger``
    defaults to a ``MetricsLogger`` on stdout; ``display`` renders game 0
    after every self-play chunk; ``persist_config=False`` (read-only
    commands) leaves ``workdir/config.json`` alone; ``fused_resnet`` is the
    fused tower opt-in for self-play, the gate and the vanilla match."""

    # the ranks' mesh of a run over several (training/spmd_loop.py)
    mesh = None

    def __init__(self, cfg: Config, device="cuda",
                 workdir: Optional[str] = None,
                 logger: Optional[MetricsLogger] = None,
                 display: bool = False, persist_config: bool = True,
                 fused_resnet: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.display = display
        self.fused_resnet = fused_resnet
        self.log = logger or MetricsLogger()
        self.env = make_env(cfg.env)
        self.model = build_model(cfg.model, self.env).to(self.device)
        gen = torch.Generator().manual_seed(cfg.train.seed)
        # best ("older") generates data; the contender ("newer") trains
        self.params_best, self.sp, self.buffer = self._initial_state(
            {k: v.to(self.device)
             for k, v in init_params(self.model, gen).items()})
        self.params_new = _copy(self.params_best)
        # draws of the learner's samples and of the gate's matches
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed + 2)
        # the learner's dropout masks
        self.dropout_generator = torch.Generator(
            device=self.device).manual_seed(cfg.train.seed + 3)
        self.version = 0
        self.outer_iter = 0
        self.reject_count = 0
        self.last_gate_score = None     # [best, contender, draws]
        self.last_vanilla_score = None  # [vanilla, model, draws]
        self._syms = Symmetries(self.env, self.device)
        self._chunk_steps = (cfg.train.selfplay_chunk_steps
                             or SELFPLAY_CHUNK_STEPS)
        self._runner = self._make_runner()
        self._ckpt = (CheckpointManager(f"{workdir}/checkpoints")
                      if workdir else None)
        self._config_dir = workdir if persist_config else None
        if self._config_dir:
            save_config(cfg, self._config_dir)

    def _initial_state(self, params: dict):
        """The run's starting parameters, self-play games and ring."""
        cfg = self.cfg
        return (params, init_selfplay(self.env, cfg.train.selfplay_batch,
                                      cfg.train.seed + 1, self.device),
                create(self.env, cfg.replay.capacity, self.device))

    def _make_runner(self):
        """The actor phase's program: ``run(params, sp, buffer)``."""
        return make_selfplay_runner(self.env, self.model, self.cfg.mcts,
                                    self.cfg.replay, self._chunk_steps,
                                    self.fused_resnet)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- phases
    def collect(self, games_target: int) -> dict:
        """Self-play with the best params until ``games_target`` new games
        finish.

        As in the JAX trainer, the loop reads the game counter from before
        the chunk it just ran, so it plays at most one chunk past the
        target; with ``display`` it reads it after each chunk, renders game
        0 and stops at the target.  Each chunk ends in a device
        synchronisation, and its seconds are reported in
        ``chunk_seconds``."""
        start_games = int(self.sp.games_done)
        start_steps = int(self.sp.env_steps)
        chunk_seconds = []
        t0 = time.perf_counter()
        while not (self.display
                   and int(self.sp.games_done) - start_games >= games_target):
            done_prev = self.sp.games_done
            tc = time.perf_counter()
            self.sp, self.buffer = self._runner(self.params_best, self.sp,
                                                self.buffer)
            self._sync()
            chunk_seconds.append(time.perf_counter() - tc)
            if self.display:
                self._show_game0()
            elif int(done_prev) - start_games >= games_target:
                break
        dt = time.perf_counter() - t0
        steps = int(self.sp.env_steps) - start_steps
        m = {
            "games": int(self.sp.games_done) - start_games,
            "env_steps": steps,
            "env_steps_per_s": steps / max(dt, 1e-9),
            "sims_per_s": steps * self.cfg.mcts.num_simulations / max(dt, 1e-9),
            "buffer_size": self._buffer_rows(),
            "results": self.sp.results.tolist(),
            "seconds": dt,
            "chunk_seconds": chunk_seconds,
        }
        self.log.log("collect", **m)
        return m

    def _show_game0(self):
        s = self.sp.env_state
        print(f"[game 0, move {int(s.move_count[0])}]\n"
              f"{self.env.render(s, 0)}", flush=True)

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
        steps = self._epoch_steps()
        t0 = time.perf_counter()
        self.params_new, metrics = learner.train_epoch(
            self._learner_net(), self.params_new, self.buffer, self.cfg.train,
            steps, generator=self.generator,
            dropout_generator=self.dropout_generator,
            syms=self._syms if self.cfg.replay.augment else None,
            augment_skip=self.cfg.replay.augment_skip_moves,
            chunk_steps=TRAIN_CHUNK_STEPS, mesh=self.mesh)
        return self._log_train(steps, metrics, t0)

    def _learner_net(self):
        return self.model

    def _log_train(self, steps: int, metrics, t0: float, **flags) -> dict:
        m = {"steps": steps, **flags,
             **{k: float(v) for k, v in metrics._asdict().items()},
             "seconds": time.perf_counter() - t0}
        self.log.log("train", **m)
        return m

    def _epoch_steps(self) -> int:
        t = self.cfg.train
        if t.train_steps_per_iter is not None:
            return t.train_steps_per_iter
        return max(self._buffer_rows() // t.batch_size, 1)

    def gate(self) -> float:
        """Contender-vs-best arena of ``gate_games`` games with visit
        sampling → the contender's win rate; 1.0 when the gate is disabled."""
        if not self.cfg.train.gate_enabled:
            return 1.0
        best = Agent(self._eval_fn(self.params_best), self.cfg.mcts)
        cont = Agent(self._eval_fn(self.params_new), self.cfg.mcts)
        rate, score = self._compare(best, cont, self.cfg.train.gate_games,
                                    sampling=True)
        self.last_gate_score = score.tolist()
        self.log.log("gate", win_rate=rate, score=self.last_gate_score)
        return rate

    def _compare(self, best: Agent, contender: Agent, games: int, **kw):
        """``eval.arena.compare`` with the trainer's generator."""
        return compare(self.env, best, contender, games,
                       generator=self.generator, device=self.device, **kw)

    def _eval_fn(self, params):
        return make_eval_fn(self.model, params, self.fused_resnet)

    def vanilla_sanity_match(self, games: int = 2) -> float:
        """The best parameters against vanilla search with
        ``min(num_simulations · max(version, 1), 400)`` rollout simulations
        → the model's win rate (draws 0.5); the score is kept in
        ``last_vanilla_score`` as [vanilla, model, draws]."""
        sims = min(self.cfg.mcts.num_simulations * max(self.version, 1), 400)
        vanilla = Agent(None, dataclasses.replace(self.cfg.mcts,
                                                  num_simulations=sims))
        model = Agent(self._eval_fn(self.params_best), self.cfg.mcts)
        rate, score = self._compare(vanilla, model, games)
        self.last_vanilla_score = score.tolist()
        self.log.log("vanilla_eval", model_win_rate=rate, vanilla_sims=sims,
                     score=self.last_vanilla_score)
        return rate

    # ------------------------------------------------------------ iteration
    def iterate(self, vanilla_eval: bool = True) -> dict:
        """One outer iteration.  A promotion saves a checkpoint (with a
        workdir); with ``vanilla_eval``, one that brings ``version`` to a
        multiple of ``vanilla_eval_every`` is followed by
        :meth:`vanilla_sanity_match`, whose rate the result holds as
        ``vanilla_win_rate``."""
        t = self.cfg.train
        self.outer_iter += 1
        games = t.games_per_iter
        if self.reject_count >= t.reject_double_after:
            games *= 2
        with span("train.collect"):
            cm = self.collect(games)
        with span("train.epoch"):
            tm = self.train_epoch()
        t0 = time.perf_counter()
        with span("train.gate"):
            rate = self.gate()
            self._sync()
        gate_seconds = time.perf_counter() - t0
        accepted = rate > t.gate_threshold
        extra = {}
        if accepted:
            self.params_best = _copy(self.params_new)
            self.version += 1
            self.reject_count = 0
            with span("train.checkpoint"):
                self.save_checkpoint()
            if vanilla_eval and self.version % t.vanilla_eval_every == 0:
                extra["vanilla_win_rate"] = self.vanilla_sanity_match()
        else:
            self.params_new = _copy(self.params_best)
            self.reject_count += 1
        m = {"iter": self.outer_iter, "version": self.version,
             "accepted": bool(accepted), "gate_rate": rate, **cm, **tm,
             "collect_seconds": cm["seconds"],
             "train_seconds": tm["seconds"], "gate_seconds": gate_seconds,
             **extra}
        self.log.log("iteration", **m)
        return m

    def run(self, iterations=None, vanilla_eval: bool = True):
        n = iterations or self.cfg.train.outer_iterations
        for _ in range(n):
            self.iterate(vanilla_eval=vanilla_eval)

    # ---------------------------------------------------------- checkpoint
    def _state(self) -> dict:
        return {
            "params_best": self.params_best,
            "params_new": self.params_new,
            "buffer": {f.name: getattr(self.buffer, f.name)
                       for f in dataclasses.fields(ReplayBuffer)},
            "generator": self.generator.get_state(),
            "dropout_generator": self.dropout_generator.get_state(),
            "version": torch.tensor(self.version),
            "outer_iter": torch.tensor(self.outer_iter),
        }

    def save_checkpoint(self):
        """Save the state at step ``version`` (with a workdir)."""
        if self._ckpt:
            self._ckpt.save(self.version, self._state())

    def restore_checkpoint(self, step: Optional[int] = None) -> bool:
        """Load the state of ``step`` (default: the latest); False when
        there is no workdir or no checkpoint.  Raises ``ValueError`` when
        its names, shapes or dtypes differ from this trainer's."""
        if not self._ckpt:
            return False
        state = self._ckpt.restore(self._state(), step=step)
        if state is None:
            return False
        self._load_state(state)
        return True

    def _load_state(self, state: dict):
        dev = self.device
        self.params_best = {k: v.to(dev) for k, v in
                            state["params_best"].items()}
        self.params_new = {k: v.to(dev) for k, v in
                           state["params_new"].items()}
        self.buffer = ReplayBuffer(**{k: v.to(dev) for k, v in
                                      state["buffer"].items()})
        self.generator.set_state(state["generator"])
        self.dropout_generator.set_state(state["dropout_generator"])
        self.version = int(state["version"])
        self.outer_iter = int(state["outer_iter"])

    def import_buffer(self, workdir: str, step: Optional[int] = None) -> int:
        """Seed this run's replay buffer with the newest ``min(size,
        capacity)`` game blocks of another run's checkpoint (the JAX
        package's ring arithmetic: oldest first, from the cursor when the
        source ring is full).  The env geometry must match.  Returns the
        blocks imported."""
        src = CheckpointManager(f"{workdir}/checkpoints").restore_raw(step)
        if src is None:
            raise FileNotFoundError(f"no checkpoint under {workdir}")
        b = src["buffer"]
        if tuple(b["obs"].shape[1:]) != tuple(self.buffer.obs.shape[1:]):
            raise ValueError(
                f"buffer geometry mismatch: source blocks "
                f"{tuple(b['obs'].shape[1:])}, this env needs "
                f"{tuple(self.buffer.obs.shape[1:])}")
        size, cursor = int(b["size"]), int(b["cursor"])
        cap_src = b["obs"].shape[0]
        k = min(size, self.buffer.capacity)
        if size < cap_src:
            idx = torch.arange(size - k, size)
        else:                      # ring full: the oldest block is at cursor
            idx = (cursor - k + torch.arange(k)) % cap_src
        dev, buf = self.device, self.buffer
        for name, dtype in (("obs", torch.int8), ("policy", torch.float32),
                            ("length", torch.int32), ("winner", torch.int32)):
            getattr(buf, name)[:k] = b[name][idx].to(dev, dtype)
        buf.cursor = torch.tensor(k % buf.capacity, dtype=torch.int32,
                                  device=dev)
        buf.size = torch.tensor(k, dtype=torch.int32, device=dev)
        return k

    def expand_depth(self, new_depth: int):
        """Grow the ViT to ``new_depth`` blocks in place: both parameter
        sets keep every parameter they share with the deeper model, and
        their new blocks get the same fresh draw (one seed from
        ``generator``).  The model, the config (and the run's
        ``config.json``) and the self-play runner are replaced.  Raises
        ``ValueError`` for another family."""
        if self.cfg.model.family != "vit":
            raise ValueError("depth expansion applies to the ViT family "
                             f"(this run: {self.cfg.model.family!r})")
        seed = int(torch.randint(2 ** 62, (1,), generator=self.generator,
                                 device=self.device))
        mcfg, self.model, self.params_best = expand_vit_depth(
            self.cfg.model, self.env, self.params_best, new_depth,
            torch.Generator().manual_seed(seed))
        _, _, self.params_new = expand_vit_depth(
            self.cfg.model, self.env, self.params_new, new_depth,
            torch.Generator().manual_seed(seed))
        self.cfg = dataclasses.replace(self.cfg, model=mcfg)
        self._runner = self._make_runner()
        if self._config_dir:
            save_config(self.cfg, self._config_dir)
