"""The port's move search against the JAX package's ``run_mcts_fused``.

``move_search_reference`` and ``run_mcts_fused(..., device="cpu")``
(alphazero_tpu_torch/search/fused.py) must reproduce
``alphazero_tpu.search.pallas_fused.run_mcts_fused(..., interpret=True)``
(its Pallas ``_move_kernel``) BITWISE in ``visit_counts``, ``policy`` and
``root_q`` under the exact stub evaluator: all games live, finished games
(won and drawn) among live ones, a full column, Dirichlet noise (JAX's draw
handed to the port) and the ``alphazero`` PUCT formula.  With real width-64
weights the counts keep their invariants and ``root_q`` stays within a
stated tolerance of JAX's.
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
from alphazero_tpu.models import build_model, init_params, make_eval_fn
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.models import build_model as build_tmodel
from alphazero_tpu_torch.models import make_eval_fn as make_teval_fn
from alphazero_tpu_torch.models import params_from_flax
from alphazero_tpu_torch.search.fused import (move_search_reference,
                                              run_mcts_fused)
from alphazero_tpu_torch.search.mcts import run_mcts
from alphazero_tpu_torch.search.stub import drawn_board as stub_drawn_board
from alphazero_tpu_torch.search.stub import exact_stub_evaluator
from tests.oracles.games import make_oracle
from tests.test_pallas_fused import _exact_stub_forwards

ORACLE = make_oracle("connect4")


def play_random(rng, max_plies):
    """One game of uniformly random legal moves, stopped after
    ``max_plies`` moves or at its end.  Returns (board, player to move,
    move count, done); a won game's player to move is the loser, as the
    env's step leaves it."""
    b = ORACLE.new_board()
    p, mc = 0, 0
    for _ in range(max_plies):
        acts = ORACLE.valid_actions(b, mc)
        cell = ORACLE.place(b, p, acts[rng.randint(len(acts))])
        mc += 1
        won = ORACLE.check_win_at(b, p, cell)
        p = 1 - p
        if won or mc >= ORACLE.max_moves:
            return b, p, mc, True
    return b, p, mc, False


def drawn_board():
    """A full board with no line for either player (21 stones each)."""
    b = stub_drawn_board(make_tenv("connect4")).numpy()
    assert b.sum() == 42
    assert not ORACLE.has_win(b, 0) and not ORACLE.has_win(b, 1)
    return b


def positions(seed, B, finished=0, drawn=False, full_column=False):
    """B roots: live mid-game positions, then ``finished`` won games, then
    (``drawn``) one drawn game; with ``full_column`` game 0 has column 3
    full."""
    rng = np.random.RandomState(seed)
    games = []
    while len(games) < B - finished - int(drawn):
        g = play_random(rng, rng.randint(0, 12))
        if not g[3]:
            games.append(g)
    while len(games) < B - int(drawn):
        g = play_random(rng, 42)
        if g[3] and g[2] < 42:
            games.append(g)
    if drawn:
        games.append((drawn_board(), 0, 42, True))
    if full_column:
        b = ORACLE.new_board()
        for i in range(6):
            ORACLE.place(b, i % 2, 3)
        games[0] = (b, 0, 6, False)
    boards, players, mcs, dones = (np.stack(x) for x in zip(*games))
    return (boards.astype(np.int8), players.astype(np.int32),
            mcs.astype(np.int32), dones.astype(bool))


def _jax_search(cfg, boards, players, mcs, dones, key, eval_fn, params=None,
                widths=(64, 1)):
    env = make_env("connect4")
    model = build_model(ModelConfig(family="dense", width=widths[0],
                                    blocks=widths[1]), env)
    params = init_params(model, env, jax.random.PRNGKey(0)) \
        if params is None else params
    res = F.run_mcts_fused(env, model, params, eval_fn or make_eval_fn(
        model, params), jnp.asarray(boards), jnp.asarray(players),
        jnp.asarray(mcs), jnp.asarray(dones), key, cfg, interpret=True)
    noise = jax.random.dirichlet(
        key, jnp.full((env.action_dim,), cfg.dirichlet_alpha, jnp.float32),
        shape=(boards.shape[0],))
    return res, np.array(noise), model, params


def _port_cfg(cfg: MCTSConfig) -> tcfg.MCTSConfig:
    return tcfg.MCTSConfig(**dataclasses.asdict(cfg))


def _stub_eval_fn(stub):
    return lambda obs: stub(obs.reshape(obs.shape[0], -1))


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


CASES = {
    "all_live": dict(),
    "finished_won_and_drawn": dict(finished=2, drawn=True),
    "full_column": dict(full_column=True),
    "dirichlet": dict(finished=1),
    "alphazero_formula": dict(finished=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_move_search_bitwise_vs_jax_move_kernel(monkeypatch, case):
    env = make_env("connect4")
    kernel_stub, xla_eval = _exact_stub_forwards(env)
    monkeypatch.setattr(F, "_leaf_eval", kernel_stub)
    cfg = MCTSConfig(num_simulations=24, use_dirichlet=False)
    if case == "dirichlet":
        cfg = dataclasses.replace(cfg, use_dirichlet=True, dirichlet_alpha=0.3)
    elif case == "alphazero_formula":
        cfg = dataclasses.replace(cfg, formula="alphazero", c_puct=1.7)
    B = 8
    boards, players, mcs, dones = positions(11, B, **CASES[case])
    key = jax.random.PRNGKey(5)
    want, noise, _, _ = _jax_search(cfg, boards, players, mcs, dones, key,
                                    xla_eval)
    want = jax.tree.map(np.asarray, want)

    tenv = make_tenv("connect4")
    stub = exact_stub_evaluator(tenv)
    args = _torch(boards, players, mcs, dones)
    kw = dict(noise=torch.as_tensor(noise), evaluator=stub)
    got = move_search_reference(tenv, None, None, _stub_eval_fn(stub), *args,
                                _port_cfg(cfg), **kw)
    for name in ("visit_counts", "policy", "root_q"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)
    # the dispatching entry point on the CPU takes the same plain stages
    got2 = run_mcts_fused(tenv, None, None, _stub_eval_fn(stub), *args,
                          _port_cfg(cfg), device="cpu", **kw)
    for name in ("visit_counts", "policy", "root_q"):
        assert torch.equal(getattr(got2, name), getattr(got, name)), name

    counts = want.visit_counts
    S = cfg.num_simulations
    np.testing.assert_array_equal(counts.sum(-1)[~dones], S - 1)
    np.testing.assert_array_equal(counts.sum(-1)[dones], 0)
    if case == "finished_won_and_drawn":
        # a finished root backs up its terminal score on every simulation:
        # (S-1)/S for a won game (the loser is to move, the mover won), 0
        # for the draw
        won = dones & (mcs < 42)
        np.testing.assert_array_equal(got.root_q.numpy()[won],
                                      np.float32(S - 1) / np.float32(S))
        assert got.root_q.numpy()[dones & (mcs == 42)].tolist() == [0.0]
    if case == "full_column":
        assert counts[0, 3] == 0


def test_move_search_real_weights_close_to_jax():
    """Width-64 weights: the port's bf16 in-search forward and the Pallas
    one differ in summation order only, so the counts keep their
    invariants exactly and root Q agrees within 0.05 per game."""
    cfg = MCTSConfig(num_simulations=24, use_dirichlet=False)
    boards, players, mcs, dones = positions(3, 6, finished=1)
    want, _, model, params = _jax_search(cfg, boards, players, mcs, dones,
                                         jax.random.PRNGKey(1), None)
    tenv = make_tenv("connect4")
    tmodel = build_tmodel(tcfg.ModelConfig(family="dense", width=64,
                                           blocks=1), tenv)
    tparams = params_from_flax(jax.tree.map(np.asarray, params))
    eval_fn = make_teval_fn(tmodel, tparams)
    got = run_mcts(tenv, eval_fn, *_torch(boards, players, mcs, dones),
                   _port_cfg(cfg), device="cpu")
    counts = got.visit_counts.numpy()
    np.testing.assert_array_equal(counts.sum(-1)[~dones], 23)
    np.testing.assert_array_equal(counts.sum(-1)[dones], 0)
    legal = (boards[:, 0, 0] + boards[:, 1, 0]) == 0
    assert not (counts[~legal] > 0).any()
    np.testing.assert_allclose(got.root_q.numpy(), np.asarray(want.root_q),
                               atol=0.05)


def test_run_mcts_dense_tictactoe_finds_immediate_win():
    """JAX's ``test_fused_finds_immediate_win``
    (``tests/test_pallas_fused.py``): a dense tictactoe tower (width 64, 1
    block, JAX's weights from key 0) searching X X . / O O . / . . . with
    150 simulations through ``run_mcts`` (the move search of
    ``search/fused.py``) puts most visits on the win, cell 2.  Leaf batching
    (``leaf_batch > 1``) runs for any network evaluator, the dense tower's
    included, on the portable engine; vanilla search ignores it, as the JAX
    package does."""
    from alphazero_tpu_torch.models import init_params as tinit
    z = torch.zeros(2, dtype=torch.int32)

    def roots(env):
        return (torch.zeros((2, 2, env.rows, env.cols), dtype=torch.int8), z,
                z, torch.zeros(2, dtype=torch.bool))

    def dense(env):
        model = build_tmodel(tcfg.ModelConfig(family="dense", width=16,
                                              blocks=1), env)
        return make_teval_fn(model, tinit(model,
                                          torch.Generator().manual_seed(0)))

    env = make_env("tictactoe")
    model = build_model(ModelConfig(family="dense", width=64, blocks=1), env)
    params = init_params(model, env, jax.random.PRNGKey(0))
    ttt = make_tenv("tictactoe")
    tmodel = build_tmodel(tcfg.ModelConfig(family="dense", width=64,
                                           blocks=1), ttt)
    eval_fn = make_teval_fn(tmodel, params_from_flax(
        jax.tree.map(np.asarray, params)))
    oracle = make_oracle("tictactoe")
    board = oracle.new_board()
    for player, cell in ((0, 0), (1, 3), (0, 1), (1, 4)):
        oracle.place(board, player, cell)
    one = torch.ones(1, dtype=torch.int32)
    res = run_mcts(ttt, eval_fn,
                   torch.as_tensor(board[None], dtype=torch.int8), 0 * one,
                   4 * one, torch.zeros(1, dtype=torch.bool),
                   tcfg.MCTSConfig(num_simulations=150, use_dirichlet=False),
                   device="cpu")
    assert int(res.visit_counts[0].argmax()) == 2
    assert int(res.visit_counts.sum()) == 149
    tenv = make_tenv("connect4")
    args = roots(tenv)
    cfg = tcfg.MCTSConfig(num_simulations=4, leaf_batch=2)
    stub = exact_stub_evaluator(tenv)
    for eval_fn in (lambda obs: stub(obs.reshape(obs.shape[0], -1)),
                    dense(tenv)):
        res = run_mcts(tenv, eval_fn, *args, cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
        assert res.visit_counts.sum(-1).tolist() == [3, 3]
    res = run_mcts(tenv, None, *args, cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    assert res.visit_counts.sum(-1).tolist() == [3, 3]
