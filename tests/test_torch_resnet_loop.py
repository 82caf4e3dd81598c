"""The port's per-move self-play and the ResNet outer iteration on the CPU.

* ``selfplay_step`` run move by move equals the JAX package's
  ``selfplay_step`` under the exact stub evaluator, bit for bit: slabs,
  env state, move counters, W/L/D counters and every replay block, with
  root Dirichlet noise and visit sampling on.  The port is handed the
  JAX draws: per step ``rng, mcts_rng, act_rng = split(sp.rng, 3)``, the
  noise ``dirichlet(split(mcts_rng, 3)[1])`` (the JAX engine's root key)
  and the gumbel draw of ``categorical(act_rng, ·)``.
* ``Trainer`` on a tiny ResNet config runs whole iterations on the CPU:
  self-play on the per-simulation engine, the learner, the gate and, when
  due, the vanilla sanity match.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alphazero_tpu.config import MCTSConfig, ReplayConfig
from alphazero_tpu.data import create
from alphazero_tpu.data.augment import Symmetries
from alphazero_tpu.envs import make_env
from alphazero_tpu.training.selfplay import init_selfplay, selfplay_step
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.data import create as tcreate
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.eval import arena
from alphazero_tpu_torch.search.mcts import run_mcts
from alphazero_tpu_torch.search.stub import exact_stub_evaluator
from alphazero_tpu_torch.training import Trainer
from alphazero_tpu_torch.training import init_selfplay as tinit_selfplay
from alphazero_tpu_torch.training.selfplay import \
    selfplay_step as tselfplay_step
from tests.test_pallas_fused import _exact_stub_forwards


def test_selfplay_step_loop_matches_jax():
    name, B, steps = "tictactoe", 6, 14
    env = make_env(name)
    _, xla_eval = _exact_stub_forwards(env)
    cfg = MCTSConfig(num_simulations=12, dirichlet_alpha=0.35,
                     temperature_moves=4)
    rcfg = ReplayConfig(capacity=9 * 16)
    sp = init_selfplay(env, B, jax.random.PRNGKey(3))
    buf = create(env, rcfg.capacity)
    step = jax.jit(lambda sp, buf: selfplay_step(
        env, xla_eval, cfg, rcfg, Symmetries(env), sp, buf))
    draws = []
    for _ in range(steps):
        _, mcts_rng, act_rng = jax.random.split(sp.rng, 3)
        noise = jax.random.dirichlet(
            jax.random.split(mcts_rng, 3)[1],
            jnp.full((env.action_dim,), cfg.dirichlet_alpha, jnp.float32),
            shape=(B,))
        gumbel = jax.random.gumbel(act_rng, (B, env.action_dim), jnp.float32)
        draws.append((torch.as_tensor(np.array(noise)),
                      torch.as_tensor(np.array(gumbel))))
        sp, buf = step(sp, buf)

    tenv = make_tenv(name)
    stub = exact_stub_evaluator(tenv)
    eval_fn = lambda obs: stub(obs.reshape(obs.shape[0], -1))  # noqa: E731
    tm = tcfg.MCTSConfig(num_simulations=12, dirichlet_alpha=0.35,
                         temperature_moves=4)
    tsp = tinit_selfplay(tenv, B, 3, device="cpu")
    tbuf = tcreate(tenv, rcfg.capacity, device="cpu")
    for noise, gumbel in draws:
        tsp, tbuf = tselfplay_step(tenv, eval_fn, tm, tsp, tbuf, noise=noise,
                                   gumbel=gumbel)

    def eq(a, b, what):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)

    eq(sp.traj_obs, tsp.traj_obs, "traj_obs")
    eq(sp.traj_policy, tsp.traj_policy, "traj_policy")
    eq(sp.t, tsp.t, "t")
    for f in ("board", "current_player", "move_count", "winner", "done"):
        eq(getattr(sp.env_state, f), getattr(tsp.env_state, f), f)
    for f in ("games_done", "env_steps", "results"):
        eq(getattr(sp, f), getattr(tsp, f), f)
    for f in ("obs", "policy", "length", "winner", "cursor", "size"):
        eq(getattr(buf, f), getattr(tbuf, f), f"buffer.{f}")
    assert int(tsp.games_done) >= B and int(tsp.env_steps) == B * steps


def _cfg(**train):
    t = dict(batch_size=16, selfplay_batch=4, games_per_iter=4, gate_games=4,
             selfplay_chunk_steps=5, train_steps_per_iter=2, seed=1,
             vanilla_eval_every=1)
    t.update(train)
    return tcfg.Config(
        env="tictactoe",
        mcts=tcfg.MCTSConfig(num_simulations=6, dirichlet_alpha=0.35,
                             temperature_moves=2),
        model=tcfg.ModelConfig(family="resnet", channels=8, blocks=1),
        replay=tcfg.ReplayConfig(capacity=9 * 32),
        train=tcfg.TrainConfig(**t))


def test_resnet_trainer_iterates_on_the_sim_engine(monkeypatch):
    trace = []

    def traced(env, eval_fn, boards, players, move_counts, dones, cfg, **kw):
        res = run_mcts(env, eval_fn, boards, players, move_counts, dones,
                       cfg, **kw)
        trace.append((eval_fn is None, cfg.num_simulations, dones,
                      res.visit_counts))
        return res

    monkeypatch.setattr(arena, "run_mcts", traced)
    tr = Trainer(_cfg(gate_threshold=-1.0), device="cpu")
    assert type(tr.model).__name__ == "ResNet"
    m = tr.iterate()
    assert m["games"] >= 4 and m["steps"] == 2 and np.isfinite(m["loss"])
    assert m["accepted"] and tr.version == 1
    assert 0.0 <= m["vanilla_win_rate"] <= 1.0
    assert sum(tr.last_gate_score[:2]) == 4
    assert sum(tr.last_vanilla_score[:2]) == 2
    size = int(tr.buffer.size)
    lens = tr.buffer.length[:size]
    assert size == m["games"] and (lens >= 5).all() and (lens <= 9).all()
    pol = tr.buffer.policy[:size]
    for g in range(size):
        np.testing.assert_allclose(pol[g, :lens[g]].sum(-1).numpy(), 1.0,
                                   atol=1e-6)
    # gate searches, then the vanilla match's (vanilla and model agents)
    assert all(not v for v, *_ in trace[:2 * 9])
    assert any(v for v, *_ in trace[2 * 9:])
    for vanilla, S, done, counts in trace:
        sums = counts.sum(-1)
        assert (sums[~done] == S - 1).all() and (sums[done] == 0).all()
