"""The next move's root observation, written by the move's tail.

* ``move_tail_reference`` with ``rec_obs_next`` returns the observation of
  the board and player it leaves, and writes its int8 record: BITWISE
  ``root_obs_reference`` of that state and the JAX env's
  ``observation_from_board``, on ``tests/test_torch_cuda.py:tail_trees``
  (games won on the move and drawn at ``max_moves``, so reset, and games
  that go on).  Its board, player, move count and records are those of the
  tail without it, which returns None.
* The plain chunk with the fold equals BITWISE a chunk that recomputes the
  root observation from the board at every move (the loop as it was
  before), with small dense towers of random weights on connect4,
  tictactoe and gomoku9 and games that finish and restart inside the chunk.
* The plain chunk computes a root observation on its own once per chunk,
  and an evaluator that keeps the root observations it was given finds
  each still equal to its move's record.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.envs import make_env
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.models import build_model, init_params
from alphazero_tpu_torch.search import fused
from alphazero_tpu_torch.search.stub import drawn_board, exact_stub_evaluator
from tests.test_torch_cuda import (TAIL_CASES, WALK_GAMES, _sim_positions,
                                   near_full, tail_records, tail_trees,
                                   win_in_one)

CPU = torch.device("cpu")


def _next_obs_record(env, B):
    """A next move's record, filled with a value no record takes."""
    return torch.full((B, env.feature_dim, env.rows, env.cols), 7,
                      dtype=torch.int8)


@pytest.mark.parametrize("game", WALK_GAMES)
def test_tail_writes_the_next_root_observation(game):
    env, jenv = make_tenv(game), make_env(game)
    B = 16
    cfg, tree, u, board, player, mc = tail_trees(env, B, 32, CPU)
    A = env.action_dim
    got, want = [(board.clone(), player.clone(), mc.clone(),
                  tail_records(B, A, CPU)) for _ in range(2)]
    rec_next = _next_obs_record(env, B)
    obs = fused.move_tail_reference(env, cfg, tree, u, *got, rec_next)
    assert fused.move_tail_reference(env, cfg, tree, u, *want) is None
    for name, x, y in zip(("board", "player", "mc"), got[:3], want[:3]):
        assert torch.equal(x, y), name
    for name in want[3]:
        assert torch.equal(got[3][name], want[3][name]), f"rec.{name}"
    b1, p1 = got[0], got[1]
    rec_want = _next_obs_record(env, B)
    assert torch.equal(obs, fused.root_obs_reference(env, b1, p1, rec_want))
    assert torch.equal(rec_next, rec_want)
    jobs = jax.vmap(jenv.observation_from_board)(jnp.asarray(b1.numpy()),
                                                 jnp.asarray(p1.numpy()))
    np.testing.assert_array_equal(obs.numpy(),
                                  np.asarray(jobs).reshape(B, -1))
    # cases 5 and 6 (tail_trees) finish on the move: an empty board, player 0
    done = got[3]["done"]
    case = torch.arange(B) % TAIL_CASES
    assert done[(case == 5) | (case == 6)].all()
    assert (obs[done] == 0).all() and (rec_next[done] == 0).all()
    assert not done.all()
    assert (obs[~done].reshape(-1, env.feature_dim, env.rows * env.cols)
            [:, :2].sum((1, 2)) > 0).all()


def _finishing_roots(env, B, seed):
    """B live roots: random play, games one move from a win, drawn boards
    three moves short of ``max_moves`` and empty boards, by b % 4."""
    board, player, mc, done = _sim_positions(env, B, seed, CPU)
    board = torch.where(done[:, None, None, None], 0, board)
    player = torch.where(done, 0, player)
    mc = torch.where(done, 0, mc)
    case = torch.arange(B) % 4
    cells, _ = win_in_one(env)
    win = case == 1
    board[win], player[win], mc[win] = 0, 0, 2 * len(cells)
    for cell in cells:
        board[win, 0, cell // env.cols, cell % env.cols] = 1
    full = case == 2
    board[full] = near_full(env, CPU)[0]
    player[full], mc[full] = 0, env.max_moves - 3
    empty = case == 3
    board[empty], player[empty], mc[empty] = 0, 0, 0
    return board.contiguous(), player.contiguous(), mc.contiguous()


def _chunk_recomputing_obs(env, cfg, board, player, mc, M, noise, unif,
                           evaluator):
    """The plain chunk as it ran before the tail wrote the next root: the
    root observation recomputed from the board at the start of each move."""
    B, A, S = board.shape[0], env.action_dim, cfg.num_simulations
    board, player, mc = board.clone(), player.clone(), mc.clone()
    rec = {name: torch.zeros((M, B, A) if name == "policy" else (M, B),
                             dtype=dt)
           for name, dt in fused._REC_TYPES.items()}
    rec_obs = torch.zeros((M, B, env.feature_dim, env.rows, env.cols),
                          dtype=torch.int8)
    tree = fused.Tree(env, B, S, CPU)
    for m in range(M):
        obs = fused.root_obs_reference(env, board, player, rec_obs[m])
        probs0, value0 = evaluator(obs)
        fused.root_init_reference(env, cfg, tree, probs0, value0, noise[m],
                                  board)
        for slot in range(1, S):
            fused.descend_leaf_reference(env, cfg, tree, board, player, mc,
                                         slot)
            fused.apply_reference(tree, slot, *evaluator(tree.obs))
        fused.move_tail_reference(env, cfg, tree, unif[m], board, player, mc,
                                  {k: v[m] for k, v in rec.items()})
    return dict(rec, obs=rec_obs, board=board, player_final=player,
                mc_final=mc)


@pytest.mark.parametrize("game", WALK_GAMES)
def test_chunk_with_the_fold_equals_recomputing_the_root(game):
    env = make_tenv(game)
    B, M = 8, 5
    cfg = MCTSConfig(num_simulations=24, dirichlet_alpha=0.3,
                     use_dirichlet=True, temperature_moves=3)
    model = build_model(tcfg.ModelConfig(family="dense", width=64, blocks=1),
                        env)
    params = init_params(model, torch.Generator().manual_seed(3))
    packed = fused.pack_dense_params(model, params, CPU)

    def evaluator(obs):
        return fused.dense_forward_reference(obs, packed)

    g = torch.Generator().manual_seed(4)
    noise = fused.dirichlet_noise(M, env.action_dim, B, 0.3, g, CPU)
    unif = torch.rand((M, B), generator=g)
    roots = _finishing_roots(env, B, 5)
    got = fused.selfplay_chunk_reference(env, model, params, *roots, cfg, M,
                                         noise=noise, unif=unif,
                                         evaluator=evaluator)
    want = _chunk_recomputing_obs(env, cfg, *roots, M, noise, unif,
                                  evaluator)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # games finished before the last move, so a reset root was searched
    assert want["done"][:-1].any()


@pytest.mark.parametrize("M", [1, 4])
def test_plain_chunk_computes_the_root_observation_once(monkeypatch, M):
    env = make_tenv("tictactoe")
    B, S = 6, 8
    cfg = MCTSConfig(num_simulations=S, use_dirichlet=False,
                     temperature_moves=2)
    calls = {"root_obs": 0, "tail_next": []}
    root_obs, move_tail = fused.PLAIN.root_obs, fused.PLAIN.move_tail

    def root_obs_spy(*a, **kw):
        calls["root_obs"] += 1
        return root_obs(*a, **kw)

    def move_tail_spy(*a, **kw):
        calls["tail_next"].append(a[8] is not None)
        return move_tail(*a, **kw)

    monkeypatch.setattr(fused.PLAIN, "root_obs", root_obs_spy)
    monkeypatch.setattr(fused.PLAIN, "move_tail", move_tail_spy)
    stub = exact_stub_evaluator(env)
    seen = []

    def evaluator(obs):
        seen.append(obs)                       # kept, not copied
        return stub(obs)

    board = torch.zeros((B, 2, env.rows, env.cols), dtype=torch.int8)
    board[-1] = drawn_board(env)
    board[-1, :, 0, 0] = 0                     # one move from a full board
    zeros = torch.zeros(B, dtype=torch.int32)
    mc = zeros.clone()
    mc[-1] = env.max_moves - 1
    out = fused.selfplay_chunk_reference(
        env, None, None, board, zeros, mc, cfg, M,
        generator=torch.Generator().manual_seed(0), evaluator=evaluator)
    assert calls["root_obs"] == 1
    assert calls["tail_next"] == [True] * (M - 1) + [False]
    roots = seen[::S]
    assert len(roots) == M
    for m, obs in enumerate(roots):
        assert torch.equal(obs, out["obs"][m].reshape(B, -1).float()), m
    assert out["done"][0, -1] and (out["obs"][1:2, -1] == 0).all()
