"""The port's per-simulation engine against the JAX package's Pallas one.

``sim_search_reference`` and ``run_mcts_sim(..., device="cpu")``
(alphazero_tpu_torch/search/sim.py, the plain versions of kernels 3 and 4)
must reproduce ``alphazero_tpu.search.pallas_mcts.run_mcts_pallas(...,
interpret=True)`` (its Pallas ``_sim_kernel`` and ``_flush_kernel``)
BITWISE in ``visit_counts`` and ``root_q`` under the exact stub evaluator
(per-action scores are small integers, priors on the 2⁻¹⁴ grid, values
multiples of 1/4: every sum either engine forms is exact): tictactoe,
connect4 and gomoku, Dirichlet noise (JAX's draw handed to the port), both
PUCT formulas (``alphazero`` in the tictactoe case), finished roots (won
and drawn) among live ones.  The
portable engine (``run_mcts_xla``) gives the same trees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig
from alphazero_tpu.envs import make_env
from alphazero_tpu.search.pallas_mcts import run_mcts_pallas
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.search.mcts import run_mcts, run_mcts_xla
from alphazero_tpu_torch.search.sim import (SimState, run_mcts_sim,
                                            sim_search_reference)
from alphazero_tpu_torch.search.stub import exact_stub_evaluator
from tests.oracles.games import make_oracle
from tests.test_pallas_fused import _exact_stub_forwards
from tests.test_torch_move import positions as connect4_positions


def finished_positions(name, B, finished, seed):
    """B roots of random play: live positions first, then ``finished``
    games played to their end (the player to move is the loser)."""
    oracle = make_oracle(name)
    rng = np.random.RandomState(seed)
    games = []
    while len(games) < B:
        want_done = len(games) >= B - finished
        b, p, mc, done = oracle.new_board(), 0, 0, False
        plies = oracle.max_moves if want_done else rng.randint(0, 5)
        for _ in range(plies):
            acts = oracle.valid_actions(b, mc)
            cell = oracle.place(b, p, acts[rng.randint(len(acts))])
            won = oracle.check_win_at(b, p, cell)
            p, mc = 1 - p, mc + 1
            if won or mc >= oracle.max_moves:
                done = True
                break
        if done == want_done:
            games.append((b, p, mc, done))
    boards, players, mcs, dones = (np.stack(x) for x in zip(*games))
    return (boards.astype(np.int8), players.astype(np.int32),
            mcs.astype(np.int32), dones.astype(bool))


CASES = {
    "tictactoe_finished_dirichlet_alphazero": dict(
        name="tictactoe", S=24, finished=3, dirichlet=True,
        formula="alphazero"),
    "connect4_won_and_drawn_dirichlet": dict(name="connect4", S=32,
                                             dirichlet=True, c4=True),
    "gomoku": dict(name="gomoku", S=20),
}


def _case(case):
    c = CASES[case]
    name = c["name"]
    cfg = MCTSConfig(num_simulations=c["S"], use_dirichlet=bool(
        c.get("dirichlet")), dirichlet_alpha=0.3)
    if c.get("formula"):
        cfg = dataclasses.replace(cfg, formula="alphazero", c_puct=1.7)
    B = 8
    if c.get("c4"):
        roots = connect4_positions(11, B, finished=2, drawn=True)
    else:
        roots = finished_positions(name, B, c.get("finished", 0), 5)
    return name, cfg, roots


def _port(cfg):
    return tcfg.MCTSConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("case", list(CASES))
def test_sim_engine_bitwise_vs_pallas_sim_kernel(case):
    name, cfg, (boards, players, mcs, dones) = _case(case)
    env = make_env(name)
    _, xla_eval = _exact_stub_forwards(env)
    key = jax.random.PRNGKey(4)
    want = run_mcts_pallas(env, xla_eval, jnp.asarray(boards),
                           jnp.asarray(players), jnp.asarray(mcs),
                           jnp.asarray(dones), key, cfg, interpret=True)
    noise = np.asarray(jax.random.dirichlet(
        key, jnp.full((env.action_dim,), cfg.dirichlet_alpha, jnp.float32),
        shape=(boards.shape[0],)))
    tenv = make_tenv(name)
    stub = exact_stub_evaluator(tenv)
    eval_fn = lambda obs: stub(obs.reshape(obs.shape[0], -1))  # noqa: E731
    args = [torch.as_tensor(a) for a in (boards, players, mcs, dones)]
    kw = dict(noise=torch.as_tensor(noise.copy()))
    got = sim_search_reference(tenv, eval_fn, *args, _port(cfg), **kw)
    np.testing.assert_array_equal(got.visit_counts.numpy(),
                                  np.asarray(want.visit_counts))
    np.testing.assert_array_equal(got.root_q.numpy(), np.asarray(want.root_q))
    np.testing.assert_array_equal(got.policy.numpy(), np.asarray(want.policy))
    S = cfg.num_simulations
    sums = got.visit_counts.sum(-1).numpy()
    assert (sums[~dones] == S - 1).all() and (sums[dones] == 0).all()
    # a finished root backs up its terminal score every simulation
    oracle = make_oracle(name)
    won = dones & np.array([oracle.has_win(b, 1 - p)
                            for b, p in zip(boards, players)])
    np.testing.assert_array_equal(got.root_q.numpy()[won],
                                  np.float32(S - 1) / np.float32(S))
    assert (got.root_q.numpy()[dones & ~won] == 0).all()
    # the entry points on the CPU: the dispatch and the portable engine
    for other in (run_mcts_sim(tenv, eval_fn, *args, _port(cfg),
                               device="cpu", **kw),
                  run_mcts(tenv, eval_fn, *args, _port(cfg), device="cpu",
                           **kw),
                  run_mcts_xla(tenv, eval_fn, *args, _port(cfg),
                               device="cpu", **kw)):
        for f in ("visit_counts", "policy", "root_q"):
            assert torch.equal(getattr(other, f), getattr(got, f)), f


def test_first_sim_step_flushes_nothing_and_state_shapes():
    """``sim_step`` at previous slot 0 leaves the tree as the root made
    it; the leaf record and observation have the kernel's layout."""
    from alphazero_tpu_torch.search.mcts import expand_root
    from alphazero_tpu_torch.search.sim import sim_step
    from alphazero_tpu_torch.search.tree import init_tree
    tenv = make_tenv("tictactoe")
    cfg = tcfg.MCTSConfig(num_simulations=6, use_dirichlet=False)
    B = 3
    z = torch.zeros(B, dtype=torch.int32)
    boards = torch.zeros((B, 2, 3, 3), dtype=torch.int8)
    stub = exact_stub_evaluator(tenv)
    eval_fn = lambda obs: stub(obs.reshape(obs.shape[0], -1))  # noqa: E731
    tree = init_tree(tenv, boards, z, z, 6)
    expand_root(tenv, cfg, tree, eval_fn, torch.zeros(B, dtype=torch.bool),
                None, None, None)
    before = (tree.stats.clone(), tree.prior.clone(), tree.children.clone())
    st = SimState.create(tenv, B, 6, "cpu")
    st.meta.fill_(1)                              # stale: must be ignored
    sim_step(tenv, cfg, tree, st, torch.rand(B, 9), torch.rand(B), 0, 1)
    for a, b in zip(before, (tree.stats, tree.prior, tree.children)):
        assert torch.equal(a, b)
    assert st.obs.shape == (B, 3, 3, 3) and st.meta.shape == (B, 8)
    assert (st.meta[:, 0] == 1).all() and (st.meta[:, 3] == 1).all()
    assert (st.obs[:, 2] == 1).all()              # player 1 to move at depth 1
