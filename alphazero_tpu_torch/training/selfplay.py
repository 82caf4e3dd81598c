"""Batched self-play: B games advance in lockstep.

Counterpart of the JAX package's ``training/selfplay.py``.  Two runners:

* the dense tower's chunk path (``selfplay_chunk_fused``) where
  ``search.fused.supports_chunk`` accepts it: one call of the
  whole-chunk search (``search/fused.py``) plays M moves for every game,
  then its per-move records are folded into the per-game trajectory slabs
  and every finished game's slab is flushed into the replay ring, once per
  done event;
* every other family, and the dense towers it refuses, one move at
  a time (:func:`selfplay_step`): a ``run_mcts`` search of all games (the
  per-simulation engine for the ResNet, the portable engine's leaf-batched
  rounds for ``leaf_batch > 1``), the action (visit-sampled before
  ``temperature_moves``, the first most-visited after), the env step, the
  position recorded in its game's slab, finished games flushed into the
  ring and reset.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from alphazero_tpu_torch.config import MCTSConfig, ReplayConfig
from alphazero_tpu_torch.data.replay import ReplayBuffer, add_games
from alphazero_tpu_torch.device import resolve_device
from alphazero_tpu_torch.envs.core import EnvState
from alphazero_tpu_torch.eval.arena import gumbel_noise
from alphazero_tpu_torch.models import make_eval_fn
from alphazero_tpu_torch.search.fused import (run_selfplay_chunk,
                                              supports_chunk)
from alphazero_tpu_torch.search.mcts import first_argmax, run_mcts
from alphazero_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class SelfPlayState:
    """Carry of the self-play loop for one batch of B games."""

    env_state: EnvState
    traj_obs: torch.Tensor     # (B, L, F, R, C) int8 canonical obs per move
    traj_policy: torch.Tensor  # (B, L, A) float32 root visit distributions
    t: torch.Tensor            # (B,) int32 moves played in the current game
    generator: torch.Generator
    games_done: torch.Tensor   # () int64 completed games (cumulative)
    env_steps: torch.Tensor    # () int64 moves made (cumulative)
    results: torch.Tensor      # (3,) int64 p0 wins / p1 wins / draws


def init_selfplay(env, batch_size: int, seed: int, device="cuda"
                  ) -> SelfPlayState:
    dev = resolve_device(device)
    B, L, A = batch_size, env.max_moves, env.action_dim
    z = dict(device=dev)
    return SelfPlayState(
        env_state=env.init(B, dev),
        traj_obs=torch.zeros((B, L, env.feature_dim, env.rows, env.cols),
                             dtype=torch.int8, **z),
        traj_policy=torch.zeros((B, L, A), dtype=torch.float32, **z),
        t=torch.zeros((B,), dtype=torch.int32, **z),
        generator=torch.Generator(device=dev).manual_seed(seed),
        games_done=torch.zeros((), dtype=torch.int64, **z),
        env_steps=torch.zeros((), dtype=torch.int64, **z),
        results=torch.zeros((3,), dtype=torch.int64, **z),
    )


def selfplay_chunk(env, model, params, mcts_cfg: MCTSConfig,
                   replay_cfg: ReplayConfig, sp: SelfPlayState,
                   buffer: ReplayBuffer, num_steps: int, *, evaluator=None):
    """``num_steps`` lockstep moves through one whole-chunk search, then the
    bookkeeping of ``selfplay_chunk_fused``: per (game, slab row) the last
    record of the chunk wins, and finished games flush per done event (a
    game can finish at most ``1 + (M-1)//min_len`` times in a chunk).
    Returns the new ``(sp, buffer)``; the buffer is updated in place."""
    with span("selfplay.chunk"):
        s = sp.env_state
        rec = run_selfplay_chunk(env, model, params, s.board,
                                 s.current_player, s.move_count, mcts_cfg,
                                 num_steps, generator=sp.generator,
                                 evaluator=evaluator, device=s.board.device)
        with span("replay.write"):
            return _record_chunk(env, sp, buffer, rec, num_steps)


def _record_chunk(env, sp: SelfPlayState, buffer: ReplayBuffer, rec,
                  M: int):
    """The chunk's records ``rec`` of M moves folded into the slabs, its
    finished games into the ring: the new ``(sp, buffer)``."""
    dev = sp.env_state.board.device
    B, L = sp.traj_policy.shape[:2]
    obs_flat = rec["obs"].reshape(M, B, -1)
    ar = torch.arange(B, device=dev)[:, None]
    lr = torch.arange(L, device=dev)
    mi = torch.arange(M, device=dev)[:, None, None]

    def overlay(slab_obs, slab_pol, m_cap):
        """Slabs with every record ``m ≤ m_cap[b]`` applied, last write
        wins.  Exact: rows are copied by index, not contracted."""
        hit = ((rec["t"][:, :, None] == lr[None, None])
               & (mi <= m_cap[None, :, None]))                    # (M, B, L)
        wm = torch.where(hit, mi + 1, 0).max(dim=0).values          # (B, L)
        src = (wm - 1).clamp(min=0)
        any_w = (wm > 0)[:, :, None]
        new_obs = torch.where(any_w, obs_flat[src, ar],
                              slab_obs.reshape(B, L, -1))
        new_pol = torch.where(any_w, rec["policy"][src, ar], slab_pol)
        return new_obs.reshape(slab_obs.shape), new_pol

    done, winner, t = rec["done"], rec["winner"], rec["t"]
    min_len = 2 * env.win_len - 1           # shortest decided game
    cum = torch.cumsum(done.to(torch.int32), dim=0)
    for k in range(1 + (M - 1) // min_len):
        event = done & (cum == k + 1)                               # (M, B)
        fired = event.any(dim=0)
        ev = event.to(torch.int32)
        m_k = torch.where(fired, ev.argmax(dim=0), -1)
        length_k = (ev * (t + 1)).sum(dim=0)
        winner_k = torch.where(fired, (ev * winner).sum(dim=0), -1)
        st_obs, st_pol = overlay(sp.traj_obs, sp.traj_policy, m_k)
        buffer = add_games(buffer, st_obs, st_pol, length_k, winner_k, fired)
    traj_obs, traj_policy = overlay(sp.traj_obs, sp.traj_policy,
                                    torch.full((B,), M - 1, device=dev))
    env_state = EnvState(
        board=rec["board"], current_player=rec["player_final"],
        move_count=rec["mc_final"],
        winner=torch.full((B,), -1, dtype=torch.int32, device=dev),
        done=torch.zeros((B,), dtype=torch.bool, device=dev))
    results = _results_update(sp.results, done, winner)
    return dataclasses.replace(
        sp, env_state=env_state, traj_obs=traj_obs, traj_policy=traj_policy,
        t=rec["mc_final"], games_done=sp.games_done + done.sum(),
        env_steps=sp.env_steps + M * B, results=results), buffer


def _results_update(results, done, winner):
    """W/L/D counters: player-0 wins, player-1 wins, draws."""
    return results + torch.stack([(done & (winner == 0)).sum(),
                                  (done & (winner == 1)).sum(),
                                  (done & (winner < 0)).sum()])


def selfplay_step(env, eval_fn, mcts_cfg: MCTSConfig, sp: SelfPlayState,
                  buffer: ReplayBuffer, *, noise=None, gumbel=None):
    """One lockstep move for all B games (B env steps), the JAX package's
    ``selfplay_step``.  The search's root Dirichlet ``noise (B, A)`` and the
    action's ``gumbel (B, A)`` draws come from ``sp.generator`` unless
    given.  Before ``temperature_moves`` an action is
    ``argmax(log π + gumbel)`` over the visited actions (the JAX package's
    ``jax.random.categorical``), after it the first most-visited action.
    Returns the new ``(sp, buffer)``; the buffer is updated in place."""
    with span("selfplay.step"):
        s = sp.env_state
        res = run_mcts(env, eval_fn, s.board, s.current_player, s.move_count,
                       s.done, mcts_cfg, generator=sp.generator, noise=noise,
                       device=s.board.device)
        with span("replay.write"):
            return _record_step(env, mcts_cfg, sp, buffer, res, gumbel)


def _record_step(env, mcts_cfg: MCTSConfig, sp: SelfPlayState,
                 buffer: ReplayBuffer, res, gumbel):
    """The move chosen from the search ``res``, played, recorded in its
    game's slab, finished games flushed into the ring: the new ``(sp,
    buffer)``."""
    s = sp.env_state
    dev = s.board.device
    B, L = sp.traj_policy.shape[:2]
    obs = env.observation(s).to(torch.int8)
    logits = torch.where(res.visit_counts > 0,
                         torch.log(torch.clamp(res.policy, min=1e-30)),
                         torch.full_like(res.policy, -float("inf")))
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, sp.generator, dev)
    sampled = first_argmax(gumbel.to(dev) + logits)
    greedy = first_argmax(res.visit_counts)
    action = torch.where(sp.t < mcts_cfg.temperature_moves, sampled,
                         greedy).to(torch.int32)
    new = env.step(s, action)
    done, winner = new.done, new.winner
    # record the position before the move in its game's slab, then flush
    # finished games into the ring
    ar = torch.arange(B, device=dev)
    t = sp.t.long()
    traj_obs, traj_policy = sp.traj_obs.clone(), sp.traj_policy.clone()
    traj_obs[ar, t] = obs
    traj_policy[ar, t] = res.policy
    buffer = add_games(buffer, traj_obs, traj_policy, sp.t + 1, winner, done)
    fresh = env.init(B, dev)
    env_state = EnvState(*(torch.where(
        done.reshape((B,) + (1,) * (getattr(new, f.name).dim() - 1)),
        getattr(fresh, f.name), getattr(new, f.name))
        for f in dataclasses.fields(EnvState)))
    return dataclasses.replace(
        sp, env_state=env_state, traj_obs=traj_obs, traj_policy=traj_policy,
        t=torch.where(done, 0, sp.t + 1).to(torch.int32),
        games_done=sp.games_done + done.sum(), env_steps=sp.env_steps + B,
        results=_results_update(sp.results, done, winner)), buffer


def make_selfplay_runner(env, model, mcts_cfg: MCTSConfig,
                         replay_cfg: ReplayConfig, num_steps: int,
                         fused_resnet: bool = False) -> Callable:
    """``runner(params, sp, buffer) -> (sp, buffer)`` advancing every game
    ``num_steps`` moves: through the whole-chunk search where
    ``supports_chunk`` accepts the game, the model and the config (the
    dense tower with sequential simulations and fewer than 510 of them, as
    the JAX package's ``supports_selfplay_fused`` requires, at shapes the
    kernels take), through ``num_steps`` :func:`selfplay_step` calls
    otherwise, with one evaluator per call of the runner
    (``make_eval_fn(..., fused_resnet)``: the fused tower's weights are
    packed once per chunk)."""
    if supports_chunk(env, model, mcts_cfg):
        def run(params, sp: SelfPlayState, buffer: ReplayBuffer):
            return selfplay_chunk(env, model, params, mcts_cfg, replay_cfg,
                                  sp, buffer, num_steps)
        return run

    def run_steps(params, sp: SelfPlayState, buffer: ReplayBuffer):
        eval_fn = make_eval_fn(model, params, fused_resnet)
        for _ in range(num_steps):
            sp, buffer = selfplay_step(env, eval_fn, mcts_cfg, sp, buffer)
        return sp, buffer

    return run_steps
