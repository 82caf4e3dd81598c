"""The port's portable search engine and rollouts against the JAX package.

* ``run_mcts_xla`` equals the JAX ``run_mcts(backend="xla")`` under the
  exact stub evaluator, bit for bit in visit counts, policy and root Q, for
  tictactoe, connect4 and gomoku (connect4 with Dirichlet noise: JAX's draw,
  ``dirichlet(split(rng, 3)[1])``, handed to the port).
* At float64 it equals the scalar oracle (tests/oracles/mcts.py) with the
  softmax stub of tests/test_mcts_parity.py: counts exactly, root Q within
  1e-9.
* Vanilla search (UCB1 + random rollouts) finds tictactoe's immediate win.
* ``rollout_values`` agrees with the oracle's playout mean: the means of
  4000 port playouts and 1000 oracle playouts of one position lie within
  0.08 of each other (the standard error of their difference is below
  0.035 for a ±1/0 outcome).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig
from alphazero_tpu.envs import make_env
from alphazero_tpu.search.mcts import run_mcts
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.search.mcts import run_mcts as trun_mcts
from alphazero_tpu_torch.search.mcts import run_mcts_xla
from alphazero_tpu_torch.search.rollout import rollout_values
from alphazero_tpu_torch.search.stub import exact_stub_evaluator
from tests.oracles.games import make_oracle
from tests.oracles.mcts import oracle_mcts
from tests.test_mcts_parity import _np_eval, _random_positions, _stub_weights
from tests.test_pallas_fused import _exact_stub_forwards

GAMES = ["tictactoe", "connect4", "gomoku"]


def _roots(name, n, seed):
    positions = _random_positions(make_oracle(name), n_pos=n, max_depth=6,
                                  seed=seed)
    return (np.stack([p[0] for p in positions]).astype(np.int8),
            np.array([p[1] for p in positions], np.int32),
            np.array([p[2] for p in positions], np.int32),
            np.zeros(n, bool))


@pytest.mark.parametrize("name", GAMES)
def test_xla_engine_bitwise_vs_jax(name):
    env = make_env(name)
    _, xla_eval = _exact_stub_forwards(env)
    dirichlet = name == "connect4"
    cfg = MCTSConfig(num_simulations=32, use_dirichlet=dirichlet,
                     dirichlet_alpha=0.3)
    roots = _roots(name, 8, 1)
    key = jax.random.PRNGKey(2)
    want = run_mcts(env, xla_eval, *(jnp.asarray(a) for a in roots), key, cfg,
                    backend="xla")
    noise = np.array(jax.random.dirichlet(
        jax.random.split(key, 3)[1],
        jnp.full((env.action_dim,), 0.3, jnp.float32), shape=(8,)))
    tenv = make_tenv(name)
    stub = exact_stub_evaluator(tenv)
    got = run_mcts_xla(tenv, lambda o: stub(o.reshape(o.shape[0], -1)),
                       *(torch.as_tensor(a) for a in roots),
                       tcfg.MCTSConfig(num_simulations=32,
                                       use_dirichlet=dirichlet,
                                       dirichlet_alpha=0.3),
                       noise=torch.as_tensor(noise), device="cpu")
    for f in ("visit_counts", "policy", "root_q"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("name", GAMES)
def test_xla_engine_float64_matches_oracle(name):
    env, oracle = make_tenv(name), make_oracle(name)
    Wp, wv = _stub_weights(env)
    tWp, twv = torch.as_tensor(Wp), torch.as_tensor(wv)

    def eval_fn(obs):
        x = obs.reshape(obs.shape[0], -1).to(torch.float64)
        e = torch.exp(x @ tWp)
        return e / e.sum(-1, keepdim=True), torch.tanh(x @ twv)

    S = 40
    boards, players, mcs, dones = _roots(name, 6, 0)
    res = run_mcts_xla(env, eval_fn, *(torch.as_tensor(a) for a in
                                       (boards, players, mcs, dones)),
                       tcfg.MCTSConfig(num_simulations=S,
                                       use_dirichlet=False),
                       dtype=torch.float64, device="cpu")
    np_eval = _np_eval(Wp, wv)
    for i in range(len(boards)):
        want_counts, want_q = oracle_mcts(oracle, boards[i].copy(),
                                          int(players[i]), int(mcs[i]), S,
                                          eval_fn=np_eval,
                                          feature_dim=env.feature_dim)
        np.testing.assert_array_equal(res.visit_counts[i].numpy(),
                                      want_counts)
        assert abs(float(res.root_q[i]) - want_q) < 1e-9, (name, i)


def test_vanilla_search_finds_the_win():
    """Player 0 holds cells 0 and 1, player 1 cells 3 and 4: cell 2 wins."""
    tenv, oracle = make_tenv("tictactoe"), make_oracle("tictactoe")
    board = oracle.new_board()
    for p, cell in ((0, 0), (1, 3), (0, 1), (1, 4)):
        oracle.place(board, p, cell)
    cfg = tcfg.MCTSConfig(num_simulations=300, use_dirichlet=False)
    res = trun_mcts(tenv, None, torch.as_tensor(board)[None],
                    torch.zeros(1, dtype=torch.int32),
                    torch.full((1,), 4, dtype=torch.int32),
                    torch.zeros(1, dtype=torch.bool), cfg,
                    generator=torch.Generator().manual_seed(3), device="cpu")
    assert int(res.visit_counts[0].argmax()) == 2
    assert int(res.visit_counts.sum()) == 299


def _oracle_playout_mean(oracle, board, player, mc, n, rng):
    total = 0.0
    mover = 1 - player
    for _ in range(n):
        b, p, m = board.copy(), player, mc
        result = 0.0
        while m < oracle.max_moves:
            acts = oracle.valid_actions(b, m)
            cell = oracle.place(b, p, acts[rng.randint(len(acts))])
            m += 1
            if oracle.check_win_at(b, p, cell):
                result = 1.0 if p == mover else -1.0
                break
            p = 1 - p
        total += result
    return total / n


@pytest.mark.parametrize("name", ["tictactoe", "connect4"])
def test_rollout_mean_matches_oracle_playouts(name):
    tenv, oracle = make_tenv(name), make_oracle(name)
    boards, players, mcs, _ = _roots(name, 3, 4)
    n = 4000
    vals = rollout_values(
        tenv, torch.as_tensor(boards).repeat_interleave(n, 0),
        torch.as_tensor(players).repeat_interleave(n),
        torch.as_tensor(mcs).repeat_interleave(n),
        torch.Generator().manual_seed(0)).reshape(3, n)
    assert set(vals.unique().tolist()) <= {-1.0, 0.0, 1.0}
    rng = np.random.RandomState(1)
    for i in range(3):
        want = _oracle_playout_mean(oracle, boards[i], int(players[i]),
                                    int(mcs[i]), 1000, rng)
        assert abs(float(vals[i].mean()) - want) <= 0.08, (i, want)
