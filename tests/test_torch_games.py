"""The port's tictactoe and gomoku envs, ``apply_path`` and symmetry tables
against the JAX package, bit for bit, and against the scalar oracle of
``tests/oracles/games.py``.

Seeded numpy random playouts step a batch of games through both packages
and compare every field after every move: boards, players, move counts,
winners, done flags, legal masks (gomoku's 8-neighbourhood with the centre
as the only opening) and canonical observations (tictactoe's to-move
plane).  The oracle replays each game move by move and must agree on the
legal actions and the winner.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.envs import make_env
from alphazero_tpu_torch.envs import make_env as make_tenv
from tests.oracles.games import make_oracle

GAMES = ["tictactoe", "gomoku", "gomoku9", "gomoku15"]


def _to_np(state):
    return {k: np.asarray(getattr(state, k)) for k in
            ("board", "current_player", "move_count", "winner", "done")}


@pytest.mark.parametrize("name", GAMES)
def test_random_playouts_bitwise_and_vs_oracle(name):
    env, tenv, oracle = make_env(name), make_tenv(name), make_oracle(name)
    B = 8
    rng = np.random.RandomState(len(name))
    state = jax.vmap(lambda _: env.init())(jnp.arange(B))
    tstate = tenv.init(B)
    step = jax.jit(jax.vmap(env.step))
    mask_fn = jax.jit(jax.vmap(env.valid_mask))
    obs_fn = jax.jit(jax.vmap(env.observation))
    boards = [oracle.new_board() for _ in range(B)]
    done = np.zeros(B, bool)
    limit = min(env.max_moves, 60)
    for move in range(limit + 1):
        want = _to_np(state)
        got = {k: v.numpy() for k, v in vars(tstate).items()}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{k} move {move}")
        mask = np.asarray(mask_fn(state))
        np.testing.assert_array_equal(tenv.valid_mask(tstate).numpy(), mask)
        np.testing.assert_array_equal(tenv.observation(tstate).numpy(),
                                      np.asarray(obs_fn(state)))
        for b in range(B):
            np.testing.assert_array_equal(got["board"][b], boards[b])
            if not done[b]:
                assert np.nonzero(mask[b])[0].tolist() == \
                    oracle.valid_actions(boards[b], move)
        if want["done"].all() or move == limit:
            break
        action = np.array([rng.choice(np.nonzero(m)[0]) if m.any() else 0
                           for m in mask], np.int32)
        for b in range(B):
            if not done[b]:
                p = move % 2
                cell = oracle.place(boards[b], p, int(action[b]))
                won = oracle.check_win_at(boards[b], p, cell)
                done[b] = won or move + 1 >= oracle.max_moves
                if won:
                    assert int(np.asarray(step(state, jnp.asarray(action))
                                          .winner)[b]) == p
        state = step(state, jnp.asarray(action))
        tstate = tenv.step(tstate, torch.as_tensor(action))
    if name == "tictactoe":
        assert tstate.done.all()


def test_gomoku_opening_is_the_centre_only():
    for size in (7, 9, 15):
        tenv = make_tenv(f"gomoku{size}")
        mask = tenv.valid_mask(tenv.init(2))
        assert mask.sum(-1).tolist() == [1, 1]
        assert int(mask[0].nonzero()) == (size // 2) * size + size // 2


@pytest.mark.parametrize("name", ["tictactoe", "connect4", "gomoku"])
def test_apply_path_matches_jax(name):
    """Random legal paths of random lengths (mask after the length) from
    random reachable roots: the same boards as the JAX one-hot sum."""
    env, tenv, oracle = make_env(name), make_tenv(name), make_oracle(name)
    rng = np.random.RandomState(7)
    B, D = 12, 8
    roots, players, actions, mask = [], [], np.zeros((B, D), np.int32), \
        np.zeros((B, D), bool)
    for b in range(B):
        board = oracle.new_board()
        n0 = rng.randint(0, 5)
        p, mc = 0, 0
        for _ in range(n0):
            acts = oracle.valid_actions(board, mc)
            oracle.place(board, p, acts[rng.randint(len(acts))])
            p, mc = 1 - p, mc + 1
        roots.append(board.copy())
        players.append(p)
        length = rng.randint(0, min(D, env.max_moves - n0 - 1) + 1)
        for d in range(D):
            if d >= length:
                actions[b, d] = rng.randint(env.action_dim)
                continue
            acts = oracle.valid_actions(board, mc)
            actions[b, d] = acts[rng.randint(len(acts))]
            mask[b, d] = True
            oracle.place(board, p, int(actions[b, d]))
            p, mc = 1 - p, mc + 1
    roots = np.stack(roots).astype(np.int8)
    players = np.array(players, np.int32)
    want = env.apply_path(jnp.asarray(roots), jnp.asarray(players),
                          jnp.asarray(actions), jnp.asarray(mask))
    got = tenv.apply_path(torch.as_tensor(roots), torch.as_tensor(players),
                          torch.as_tensor(actions), torch.as_tensor(mask))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["tictactoe", "connect4", "gomoku9"])
def test_symmetry_tables_match_jax(name):
    want = make_env(name).symmetries()
    got = make_tenv(name).symmetries()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
