"""The port's self-play bookkeeping against the JAX chunk runner, and the
port's trainer on the CPU.

``selfplay_chunk`` (alphazero_tpu_torch/training/selfplay.py) must leave
the same trajectory slabs, replay blocks and counters as the JAX package's
``selfplay_chunk_fused(..., interpret=True)`` under the exact stub
evaluator (no Dirichlet noise, greedy actions), bit for bit.
"""

import jax
import numpy as np

import alphazero_tpu.search.pallas_fused as F
from alphazero_tpu.config import MCTSConfig, ModelConfig, ReplayConfig
from alphazero_tpu.data import create, num_rows
from alphazero_tpu.data.augment import Symmetries
from alphazero_tpu.envs import make_env
from alphazero_tpu.models import build_model, init_params
from alphazero_tpu.training.selfplay import init_selfplay, selfplay_chunk_fused
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.data import create as tcreate
from alphazero_tpu_torch.data import num_rows as tnum_rows
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.search.stub import exact_stub_evaluator
from alphazero_tpu_torch.training import Trainer
from alphazero_tpu_torch.training import init_selfplay as tinit_selfplay
from alphazero_tpu_torch.training import selfplay_chunk
from tests.test_pallas_fused import _exact_stub_forwards


def test_selfplay_chunk_slabs_buffer_counters_match_jax(monkeypatch):
    env = make_env("connect4")
    model = build_model(ModelConfig(family="dense", width=64, blocks=1), env)
    params = init_params(model, env, jax.random.PRNGKey(0))
    kernel_stub, _ = _exact_stub_forwards(env)
    monkeypatch.setattr(F, "_leaf_eval", kernel_stub)
    cfg = MCTSConfig(num_simulations=12, temperature_moves=0,
                     use_dirichlet=False)
    rcfg = ReplayConfig(capacity=42 * 16)
    B, M, chunks = 4, 12, 3
    sp = init_selfplay(env, B, jax.random.PRNGKey(1))
    buf = create(env, rcfg.capacity)
    for _ in range(chunks):
        sp, buf = selfplay_chunk_fused(env, model, params, cfg, rcfg,
                                       Symmetries(env), sp, buf, M,
                                       interpret=True)

    tenv = make_tenv("connect4")
    tcfg_m = tcfg.MCTSConfig(num_simulations=12, temperature_moves=0,
                             use_dirichlet=False)
    tsp = tinit_selfplay(tenv, B, 1, device="cpu")
    tbuf = tcreate(tenv, rcfg.capacity, device="cpu")
    for _ in range(chunks):
        tsp, tbuf = selfplay_chunk(tenv, None, None, tcfg_m,
                                   tcfg.ReplayConfig(capacity=rcfg.capacity),
                                   tsp, tbuf, M,
                                   evaluator=exact_stub_evaluator(tenv))

    def eq(a, b, what):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)

    eq(sp.traj_obs, tsp.traj_obs, "traj_obs")
    eq(sp.traj_policy, tsp.traj_policy, "traj_policy")
    eq(sp.t, tsp.t, "t")
    eq(sp.env_state.board, tsp.env_state.board, "board")
    eq(sp.env_state.current_player, tsp.env_state.current_player, "player")
    eq(sp.env_state.move_count, tsp.env_state.move_count, "move_count")
    eq(sp.games_done, tsp.games_done, "games_done")
    eq(sp.env_steps, tsp.env_steps, "env_steps")
    eq(sp.results, tsp.results, "results")
    for name in ("obs", "policy", "length", "winner", "cursor", "size"):
        eq(getattr(buf, name), getattr(tbuf, name), f"buffer.{name}")
    eq(num_rows(buf), tnum_rows(tbuf), "num_rows")
    assert int(tsp.games_done) > 0


def test_trainer_collect_tiny_on_cpu():
    cfg = tcfg.Config(
        env="connect4",
        mcts=tcfg.MCTSConfig(num_simulations=8, dirichlet_alpha=0.3,
                             temperature_moves=4),
        model=tcfg.ModelConfig(family="dense", width=64, blocks=1),
        replay=tcfg.ReplayConfig(capacity=42 * 32),
        train=tcfg.TrainConfig(selfplay_batch=4, selfplay_chunk_steps=16,
                               seed=3))
    tr = Trainer(cfg, device="cpu")
    m = tr.collect(games_target=2)
    assert m["env_steps"] == 16 * 4 * len(m["chunk_seconds"])
    assert m["games"] >= 2 and sum(m["results"]) == m["games"]
    size = int(tr.buffer.size)
    assert size == m["games"]
    lens = tr.buffer.length[:size].numpy()
    assert (lens >= 7).all() and (lens <= 42).all()
    pol = tr.buffer.policy.numpy()
    obs = tr.buffer.obs.numpy()
    for g in range(size):
        np.testing.assert_allclose(pol[g, :lens[g]].sum(-1), 1.0, atol=1e-6)
        stones = obs[g, :lens[g], :2].reshape(lens[g], -1).sum(-1)
        np.testing.assert_array_equal(stones, np.arange(lens[g]))

