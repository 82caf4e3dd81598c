"""The port's arena against the JAX package's ``eval/arena.py``.

A small dense connect4 match (8 games, visit sampling for the first 20
moves, root Dirichlet noise on) must give the same winner vector and score
in both packages.  On the CPU the JAX ``compare`` would take its XLA engine
(the fused path needs a TPU), so the test routes the JAX agents through
``run_mcts_fused(..., interpret=True)`` — the Pallas ``_move_kernel`` the
gate runs on the TPU — with the exact stub evaluator in and around the
kernel, and hands the port the Dirichlet and gumbel draws that path makes:
per move ``rng, ka, kb = split(rng, 3)``, then per agent key ``k``
``dirichlet(k, ...)`` for the root noise and ``gumbel(fold_in(k, 1), ...)``
for ``jax.random.categorical``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphazero_tpu.eval.arena as jarena
import alphazero_tpu.search.pallas_fused as F
from alphazero_tpu.config import MCTSConfig, ModelConfig
from alphazero_tpu.envs import make_env
from alphazero_tpu.models import build_model, init_params
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.eval import arena as tarena
from alphazero_tpu_torch.models import build_model as build_tmodel
from alphazero_tpu_torch.models import make_eval_fn as make_teval_fn
from alphazero_tpu_torch.models import params_from_flax
from alphazero_tpu_torch.search import fused as tfused
from alphazero_tpu_torch.search.stub import exact_stub_evaluator
from tests.test_pallas_fused import _exact_stub_forwards

GAMES, SAMPLING_MOVES = 8, 20


def _jax_draws(key, agents, h, A, T):
    """The noise and gumbel draws of the JAX match for (move, agent)."""
    noise = np.zeros((T, 2, h, A), np.float32)
    gumbel = np.zeros((T, 2, h, A), np.float32)
    rng = key
    for t in range(T):
        rng, ka, kb = jax.random.split(rng, 3)
        for k, (kk, agent) in enumerate(zip((ka, kb), agents)):
            alpha = jnp.full((A,), agent.mcts.dirichlet_alpha, jnp.float32)
            noise[t, k] = jax.random.dirichlet(kk, alpha, shape=(h,))
            gumbel[t, k] = jax.random.gumbel(jax.random.fold_in(kk, 1),
                                             (h, A), jnp.float32)
    return {"noise": torch.as_tensor(noise), "gumbel": torch.as_tensor(gumbel)}


def test_arena_same_winners_and_score_as_jax(monkeypatch):
    env = make_env("connect4")
    kernel_stub, xla_eval = _exact_stub_forwards(env)
    monkeypatch.setattr(F, "_leaf_eval", kernel_stub)
    model = build_model(ModelConfig(family="dense", width=64, blocks=1), env)
    params = init_params(model, env, jax.random.PRNGKey(0))

    def fused_run_mcts(env_, eval_fn, boards, players, mcs, dones, rng, cfg,
                       use_dirichlet=None, **_):
        return F.run_mcts_fused(env_, model, params, eval_fn, boards,
                                players, mcs, dones, rng, cfg, use_dirichlet,
                                interpret=True)

    monkeypatch.setattr(jarena, "run_mcts", fused_run_mcts)
    captured = {}
    make_play = jarena.make_play_games

    def capturing_make_play(*args, **kw):
        play = make_play(*args, **kw)

        def run(rng, B):
            captured["w"] = np.asarray(play(rng, B))
            return captured["w"]
        return run

    monkeypatch.setattr(jarena, "make_play_games", capturing_make_play)
    cfg_best = MCTSConfig(num_simulations=10, dirichlet_alpha=0.3)
    cfg_cont = dataclasses.replace(cfg_best, num_simulations=6,
                                   formula="alphazero", c_puct=1.7)
    best, cont = jarena.Agent(xla_eval, cfg_best), jarena.Agent(xla_eval,
                                                                cfg_cont)
    key = jax.random.PRNGKey(9)
    rate, score = jarena.compare(env, best, cont, GAMES, key, sampling=True,
                                 sampling_moves=SAMPLING_MOVES)

    tenv = make_tenv("connect4")
    stub = exact_stub_evaluator(tenv)
    monkeypatch.setattr(tfused, "dense_forward", lambda obs, packed: stub(obs))
    tmodel = build_tmodel(tcfg.ModelConfig(family="dense", width=64,
                                           blocks=1), tenv)
    eval_fn = make_teval_fn(tmodel, params_from_flax(
        jax.tree.map(np.asarray, params)))
    root_fn = lambda obs: stub(obs.reshape(obs.shape[0], -1))  # noqa: E731
    root_fn.dense_spec = eval_fn.dense_spec
    tbest = tarena.Agent(root_fn, tcfg.MCTSConfig(
        **dataclasses.asdict(cfg_best)))
    tcont = tarena.Agent(root_fn, tcfg.MCTSConfig(
        **dataclasses.asdict(cfg_cont)))
    draws = _jax_draws(key, (best, cont), GAMES // 2, env.action_dim,
                       env.max_moves)
    trace = []
    w = tarena.make_play_games(tenv, tbest, tcont,
                               sampling_moves=SAMPLING_MOVES, device="cpu")(
        GAMES, draws=draws, trace=trace)
    np.testing.assert_array_equal(w.numpy(), captured["w"])
    trate, tscore = tarena.match_score(w.numpy(), GAMES)
    assert trate == rate
    np.testing.assert_array_equal(tscore, score)
    assert tscore[:2].sum() == GAMES
    # every search: live roots count S-1 visits, finished roots none
    assert len(trace) == 2 * env.max_moves
    for t, k, done, counts in trace:
        S = (cfg_best, cfg_cont)[k].num_simulations
        sums = counts.sum(-1)
        assert (sums[~done] == S - 1).all() and (sums[done] == 0).all(), t


def test_match_score_side_swap_and_draws():
    """Winner codes are per agent (0 best, 1 contender, -1 draw): draws
    give each side half a point and the rate is the contender's share."""
    rate, score = tarena.match_score(np.array([0, 1, -1, 1, 1, 0]), 6)
    np.testing.assert_array_equal(score, [2.5, 3.5, 1.0])
    assert rate == 3.5 / 6


def test_compare_draws_its_own_noise_on_cpu():
    """Without ``draws`` the match draws from its generator: the same seed
    gives the same match, and every game is decided or drawn."""
    tenv = make_tenv("connect4")
    tmodel = build_tmodel(tcfg.ModelConfig(family="dense", width=64,
                                           blocks=1), tenv)
    from alphazero_tpu_torch.models import init_params as tinit
    params = tinit(tmodel, torch.Generator().manual_seed(0))
    agent = tarena.Agent(make_teval_fn(tmodel, params),
                         tcfg.MCTSConfig(num_simulations=4,
                                         dirichlet_alpha=0.3))
    out = [tarena.compare(tenv, agent, agent, 4, sampling=True,
                          generator=torch.Generator().manual_seed(3),
                          device="cpu") for _ in range(2)]
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert out[0][1][:2].sum() == 4 and 0.0 <= out[0][0] <= 1.0
    with pytest.raises(ValueError, match="even"):
        tarena.make_play_games(tenv, agent, agent, device="cpu")(3)
