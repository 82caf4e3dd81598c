"""Leaf-batched search (``MCTSConfig.leaf_batch = K > 1``) against the JAX
package's ``_simulate_round``.

* ``run_mcts`` with a network evaluator and K > 1 runs the portable
  engine's rounds (``search/mcts.py:simulate_round``) and equals the JAX
  ``run_mcts(backend="xla")`` bit for bit in visit counts, policy and root
  Q under the exact stub evaluator, for connect4 with Dirichlet noise at
  (S, K) = (41, 4), (40, 4), (50, 8) and (13, 16) (partial last rounds and K
  over the budget) and for tictactoe.  The port is handed JAX's root noise,
  ``dirichlet(split(rng, 3)[1])``.  The K backups of a round add to shared
  path prefixes: the stub's values are multiples of 1/4, so their sums are
  exact in any order.
* Every live root counts S-1 visits, finished roots none.
* ``selfplay_step`` with K = 4 gives the JAX package's slabs, env state,
  counters and replay blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig, ReplayConfig
from alphazero_tpu.data import create
from alphazero_tpu.data.augment import Symmetries
from alphazero_tpu.envs import make_env
from alphazero_tpu.search.mcts import run_mcts
from alphazero_tpu.training.selfplay import init_selfplay, selfplay_step
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.data import create as tcreate
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.search.mcts import run_mcts as trun_mcts
from alphazero_tpu_torch.search.stub import exact_stub_evaluator
from alphazero_tpu_torch.training import init_selfplay as tinit_selfplay
from alphazero_tpu_torch.training.selfplay import \
    selfplay_step as tselfplay_step
from tests.test_pallas_fused import _exact_stub_forwards
from tests.test_torch_xla import _roots


def _stub(tenv):
    stub = exact_stub_evaluator(tenv)
    return lambda obs: stub(obs.reshape(obs.shape[0], -1))


@pytest.mark.parametrize("name,S,K,dirichlet", [
    ("connect4", 41, 4, True), ("connect4", 40, 4, True),
    ("connect4", 50, 8, True), ("connect4", 13, 16, True),
    ("tictactoe", 30, 4, False)])
def test_leaf_batched_search_bitwise_vs_jax(name, S, K, dirichlet):
    env = make_env(name)
    _, xla_eval = _exact_stub_forwards(env)
    kw = dict(num_simulations=S, leaf_batch=K, use_dirichlet=dirichlet,
              dirichlet_alpha=0.3)
    roots = _roots(name, 8, 1)
    if name == "connect4":               # a finished game among the roots
        roots[3][-1] = True
    key = jax.random.PRNGKey(2)
    want = run_mcts(env, xla_eval, *(jnp.asarray(a) for a in roots), key,
                    MCTSConfig(**kw), backend="xla")
    noise = np.array(jax.random.dirichlet(
        jax.random.split(key, 3)[1],
        jnp.full((env.action_dim,), 0.3, jnp.float32), shape=(8,)))
    got = trun_mcts(make_tenv(name), _stub(make_tenv(name)),
                    *(torch.as_tensor(a) for a in roots),
                    tcfg.MCTSConfig(**kw), noise=torch.as_tensor(noise),
                    device="cpu")
    for f in ("visit_counts", "policy", "root_q"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    sums = got.visit_counts.sum(-1).numpy()
    done = roots[3]
    assert (sums[~done] == S - 1).all() and (sums[done] == 0).all()


def test_leaf_batched_selfplay_step_matches_jax():
    name, B, steps = "tictactoe", 6, 12
    env = make_env(name)
    _, xla_eval = _exact_stub_forwards(env)
    kw = dict(num_simulations=13, leaf_batch=4, dirichlet_alpha=0.35,
              temperature_moves=4)
    cfg = MCTSConfig(**kw)
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
    tsp = tinit_selfplay(tenv, B, 3, device="cpu")
    tbuf = tcreate(tenv, rcfg.capacity, device="cpu")
    for noise, gumbel in draws:
        tsp, tbuf = tselfplay_step(tenv, _stub(tenv), tcfg.MCTSConfig(**kw),
                                   tsp, tbuf, noise=noise, gumbel=gumbel)

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
    assert int(tsp.games_done) >= B
