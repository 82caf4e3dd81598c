"""The port's plain whole-chunk search against the JAX chunk kernel.

``selfplay_chunk_reference`` (alphazero_tpu_torch/search/fused.py) must
reproduce ``run_selfplay_chunk_fused(..., interpret=True)`` BITWISE under the
exact stub evaluator in every configuration of the Pallas kernel: the plain
and pipelined sim loops, the d0-only peel tier, more sim-loop segments than
simulations, Dirichlet noise with temperature sampling (the JAX noise and
uniforms are recomputed from its key and handed to the port), and the
``alphazero`` PUCT formula with its ``c_puct``.  One case with
real dense weights holds the first move to a stated tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphazero_tpu.search.pallas_fused as F
from alphazero_tpu.config import MCTSConfig, ModelConfig
from alphazero_tpu.envs import make_env
from alphazero_tpu.models import build_model, init_params
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.models import build_model as build_tmodel
from alphazero_tpu_torch.models import params_from_flax
from alphazero_tpu_torch.search.fused import (game_tables,
                                              selfplay_chunk_reference)
from alphazero_tpu_torch.search.stub import exact_stub_evaluator
from tests.oracles.games import make_oracle
from tests.test_pallas_fused import _exact_stub_forwards


def _boards():
    """tests/test_pallas_fused.py's chunk boards: game 1 starts one move
    from a win for player 0."""
    oracle = make_oracle("connect4")
    b0 = oracle.new_board()
    b1 = oracle.new_board()
    for c in range(3):
        oracle.place(b1, 0, c)
        oracle.place(b1, 1, c)
    boards = np.stack([b0, b1, b0, b1]).astype(np.int8)
    players = np.array([0, 0, 1, 0], np.int32)
    mcs = np.array([0, 6, 0, 6], np.int32)
    return boards, players, mcs


def _jax_noise(key, cfg, M, A, B):
    """The noise and uniforms run_selfplay_chunk_fused draws from ``key``
    (search/pallas_fused.py:1061-1075); the kernel reads uniform row m·8."""
    rng_n, rng_u = jax.random.split(key)
    g = jax.random.gamma(rng_n, jnp.float32(cfg.dirichlet_alpha),
                         shape=(M, A, B))
    noise = g / jnp.sum(g, axis=1, keepdims=True)
    unif = jax.random.uniform(rng_u, (M * 8, B), jnp.float32)[::8]
    return np.array(noise), np.array(unif)


def _port_cfg(cfg: MCTSConfig) -> tcfg.MCTSConfig:
    return tcfg.MCTSConfig(**dataclasses.asdict(cfg))


def _run_both(cfg, boards, players, mcs, M, key, pipelined=None,
              evaluators=None, jax_params=None, widths=(64, 1)):
    env = make_env("connect4")
    model = build_model(ModelConfig(family="dense", width=widths[0],
                                    blocks=widths[1]), env)
    params = init_params(model, env, jax.random.PRNGKey(0)) \
        if jax_params is None else jax_params
    got = F.run_selfplay_chunk_fused(
        env, model, params, jnp.asarray(boards), jnp.asarray(players),
        jnp.asarray(mcs), key, cfg, M, interpret=True, pipelined=pipelined)
    want = jax.tree.map(np.asarray, got)

    tenv = make_tenv("connect4")
    tmodel = build_tmodel(tcfg.ModelConfig(family="dense", width=widths[0],
                                           blocks=widths[1]), tenv)
    tparams = params_from_flax(jax.tree.map(np.asarray, params))
    noise, unif = _jax_noise(key, cfg, M, env.action_dim, boards.shape[0])
    port = selfplay_chunk_reference(
        tenv, tmodel, tparams, torch.as_tensor(boards),
        torch.as_tensor(players), torch.as_tensor(mcs), _port_cfg(cfg), M,
        noise=torch.as_tensor(noise), unif=torch.as_tensor(unif),
        evaluator=evaluators)
    port = {k: v.numpy() for k, v in port.items()}
    return want, port


KEYS = ("obs", "policy", "player", "t", "action", "done", "winner", "root_q",
        "board", "player_final", "mc_final")


@pytest.mark.parametrize("case", ["plain", "pipelined", "d0_only",
                                  "nseg_exceeds_sims", "dirichlet_sampled",
                                  "alphazero_formula"])
def test_chunk_reference_bitwise_vs_jax_chunk_kernel(monkeypatch, case):
    kernel_stub, _ = _exact_stub_forwards(make_env("connect4"))
    monkeypatch.setattr(F, "_leaf_eval", kernel_stub)
    cfg = MCTSConfig(num_simulations=24, temperature_moves=0,
                     use_dirichlet=False)
    boards, players, mcs = _boards()
    M, pipelined = 10, False
    if case == "pipelined":
        pipelined = True
    elif case == "d0_only":
        monkeypatch.setattr(F, "_use_d1", lambda env_: False)
        monkeypatch.setattr(F, "_use_d2", lambda env_: False)
    elif case == "nseg_exceeds_sims":
        cfg = dataclasses.replace(cfg, num_simulations=8, nseg=10)
        M = 4
    elif case == "dirichlet_sampled":
        cfg = dataclasses.replace(cfg, use_dirichlet=True, dirichlet_alpha=0.3,
                                  temperature_moves=8)
    elif case == "alphazero_formula":
        cfg = dataclasses.replace(cfg, formula="alphazero", c_puct=1.7)
    want, port = _run_both(cfg, boards, players, mcs, M,
                           jax.random.PRNGKey(7), pipelined=pipelined,
                           evaluators=exact_stub_evaluator(make_tenv("connect4")))
    for k in KEYS:
        np.testing.assert_array_equal(port[k], want[k], err_msg=k)
    assert want["done"].any()
    if case == "dirichlet_sampled":
        # the uniforms decided some actions: not every move was the argmax
        greedy = want["policy"].argmax(-1)
        assert (want["action"] != greedy).any()


@pytest.mark.parametrize("game", ["connect4", "tictactoe", "gomoku",
                                  "gomoku9", "gomoku15"])
def test_game_tables_match_jax(game):
    """``aux``, ``W`` and the lines as JAX's ``_game_tables``; the env's
    ``valid_mask_board``, which the plain search versions use off
    connect4, is JAX's in-kernel rule (the ``aux`` product, the centre on
    an empty board) on random boards."""
    env, tenv = make_env(game), make_tenv(game)
    want = F._game_tables(env)
    got = game_tables(tenv)
    for k in ("W", "aux"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for j, cells in enumerate(got["lines"]):
        np.testing.assert_array_equal(np.nonzero(want["W"][:, j])[0], cells)
    rng = np.random.RandomState(0)
    R, C, RC = env.rows, env.cols, env.rows * env.cols
    boards = (rng.rand(16, 2, R, C) < rng.rand(16, 1, 1, 1) * 0.5
              ).astype(np.int8)
    boards[:, 1] *= 1 - boards[:, 0]
    if game == "connect4":                   # stones rest on the bottom
        boards = np.sort(boards.sum(1, keepdims=True), axis=2) * np.stack(
            [np.ones((R, C)), np.zeros((R, C))])[None].astype(np.int8)
    boards[0] = 0
    occ = (boards[:, 0] + boards[:, 1]).reshape(16, RC).T.astype(np.float32)
    aux = want["aux"]
    if game == "connect4":
        kernel = (aux @ occ < R).T
    elif game.startswith("gomoku"):
        centre = np.arange(RC)[:, None] == (R // 2) * C + C // 2
        kernel = np.where(occ.max(0, keepdims=True) > 0,
                          (aux @ occ > 0) & (occ == 0), centre).T
    else:
        kernel = (occ == 0).T
    np.testing.assert_array_equal(
        tenv.valid_mask_board(torch.as_tensor(boards), None).numpy(), kernel)


def test_chunk_reference_real_weights_close_to_jax():
    """Real dense weights (width 64, 1 block): the bf16 forwards differ only
    in summation order, so the first move's root policy agrees within 0.1
    total variation per game and the first action agrees in ≥ 3 of 4
    games."""
    cfg = MCTSConfig(num_simulations=24, temperature_moves=0,
                     use_dirichlet=False)
    boards, players, mcs = _boards()
    want, port = _run_both(cfg, boards, players, mcs, 2,
                           jax.random.PRNGKey(3))
    tv = np.abs(port["policy"][0] - want["policy"][0]).sum(-1)
    assert tv.max() <= 0.1, tv
    assert (port["action"][0] == want["action"][0]).sum() >= 3
    np.testing.assert_allclose(port["root_q"][0], want["root_q"][0], atol=0.05)
