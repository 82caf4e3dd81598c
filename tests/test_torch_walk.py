"""The per-simulation walk of the dense searches: its tie cases and its
launch geometry.

* ``search_geometry`` (the launch geometry of ``az_descend_leaf`` and
  ``az_apply``: a group of G lanes per game, G from the action count) for
  every action count the kernels take and the batches the searches use.
* ``descend_leaf_reference`` and ``apply_reference`` on the trees of the
  card-only test (``tests/test_torch_cuda.py:walk_trees``: tied fresh
  roots, gomoku's centre opening, a walk cut at its cap, a terminal child,
  a finished root): the walk finds what each case holds and the backup
  adds one visit per ply.
* The plain whole-chunk search against JAX's
  ``run_selfplay_chunk_fused(..., interpret=True)`` BITWISE under an
  evaluator of uniform priors and value 0, where every UCB comparison of
  unvisited edges is an exact tie and the first maximum decides, at
  connect4 and gomoku9 (its empty boards open at the centre alone).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphazero_tpu.search.pallas_fused as F
from alphazero_tpu.config import MCTSConfig
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.search import fused
from tests.test_torch_chunk import KEYS, _boards, _port_cfg
from tests.test_torch_cuda import WALK_GAMES, check_walk_cases, walk_trees
from tests.test_torch_dense_games import _dense, chunk_roots


@pytest.mark.parametrize("A,G", [(1, 8), (7, 8), (8, 8), (9, 16), (16, 16),
                                 (17, 32), (49, 32), (81, 32), (128, 32)])
def test_search_geometry(A, G):
    """G is the smallest of 8, 16 and 32 that holds A, else 32; a CTA of
    128 lanes holds 128 / G games; the CTAs cover B games and no more."""
    assert fused.search_group(A) == G
    assert -(-A // G) <= fused.MAX_ACTIONS // 32      # edges a lane reads
    for B in (1, 17, 128, 129, 256, 512):
        geo = fused.search_geometry(B, A)
        games = geo["games_per_cta"]
        assert geo["lanes_per_game"] == G
        assert games * G == geo["threads_per_cta"] == fused.SEARCH_THREADS
        assert (geo["ctas"] - 1) * games < B <= geo["ctas"] * games


def test_search_geometry_of_the_presets_and_refusals():
    """connect4 four games a warp, tictactoe two, gomoku a warp each; B=128
    at gomoku9 spreads over 32 CTAs; what the kernels refuse raises."""
    want = {"connect4": 8, "tictactoe": 16, "gomoku": 32, "gomoku9": 32}
    for game, G in want.items():
        assert fused.search_group(make_tenv(game).action_dim) == G
    assert fused.search_geometry(128, 81)["ctas"] == 32
    assert fused.search_geometry(512, 7)["ctas"] == 32
    for A in (0, 129, make_tenv("gomoku15").action_dim):
        with pytest.raises(ValueError):
            fused.search_group(A)
    with pytest.raises(ValueError):
        fused.search_geometry(0, 7)


@pytest.mark.parametrize("game", WALK_GAMES)
def test_walk_cases_plain(game):
    """The plain descent finds each case of ``walk_trees``; the plain apply
    adds one visit per ply of the walk (1.5 at an expanded leaf)."""
    env = make_tenv(game)
    dev = torch.device("cpu")
    cfg, tree, board, player, mc, slot = walk_trees(env, 12, 21, dev)
    root_child = tree.child[:, 0].clone()
    fused.descend_leaf_reference(env, cfg, tree, board, player, mc, slot)
    check_walk_cases(env, tree, root_child)
    pend = tree.pend.long()
    before = tree.visit.clone()
    probs = torch.full((12, env.action_dim), 1.0 / env.action_dim)
    fused.apply_reference(tree, slot, probs, torch.zeros(12))
    expand = (pend[:, fused.P_ALLOC] == 1) & (pend[:, fused.P_TERMINAL] == 0)
    added = (tree.visit - before).sum(-1)
    assert torch.equal(added, pend[:, fused.P_DEPTH].float() + 1
                       + 0.5 * expand.float())
    assert (tree.child[expand, slot] != fused.ILLEGAL).any(-1).all()


def _uniform_evaluators(A):
    """(JAX in-kernel stub, port evaluator): every prior 1/A on the 2⁻¹⁴
    grid, every value 0."""
    q = np.floor(16384.0 / A + 0.5) / 16384.0

    def kernel_stub(env_, model, wrefs, obs, W_lines, cfg=None):
        B = obs.shape[1]
        return (jnp.full((A, B), q, jnp.float32),
                jnp.zeros((1, B), jnp.float32))

    def port(obs):
        B = obs.shape[0]
        return (torch.full((B, A), float(q), dtype=torch.float32),
                torch.zeros(B, dtype=torch.float32))

    return kernel_stub, port


@pytest.mark.parametrize("game", ["connect4", "gomoku9"])
def test_chunk_reference_ties_bitwise_vs_jax_chunk_kernel(monkeypatch, game):
    env, model, params, tenv, tmodel, tparams = _dense(game)
    kernel_stub, port = _uniform_evaluators(env.action_dim)
    monkeypatch.setattr(F, "_leaf_eval", kernel_stub)
    cfg = MCTSConfig(num_simulations=24, temperature_moves=0,
                     use_dirichlet=False)
    boards, players, mcs = _boards() if game == "connect4" \
        else chunk_roots(game)
    M, key = 2, jax.random.PRNGKey(3)
    want = jax.tree.map(np.asarray, F.run_selfplay_chunk_fused(
        env, model, params, jnp.asarray(boards), jnp.asarray(players),
        jnp.asarray(mcs), key, cfg, M, interpret=True))
    got = fused.selfplay_chunk_reference(
        tenv, tmodel, tparams, torch.as_tensor(boards),
        torch.as_tensor(players), torch.as_tensor(mcs), _port_cfg(cfg), M,
        unif=torch.zeros((M, boards.shape[0])), evaluator=port)
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # ties everywhere: the first move of an empty board is the first
    # legal action (connect4) or the centre (gomoku9)
    first = 0 if game == "connect4" else (env.rows // 2) * env.cols \
        + env.cols // 2
    assert (want["action"][0][mcs == 0] == first).all()
