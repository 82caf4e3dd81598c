"""The two ends of a chunk move: the tree init and the move's tail.

* ``root_init_reference`` on the trees of the card-only test
  (``tests/test_torch_cuda.py:root_trees``: empty, near-full, one-stone and
  full boards on a dirty tree, with Dirichlet noise and without): each case
  holds its legal actions, the root row and nothing below it changes.
* Its legal mask against the JAX env's ``valid_mask`` on the same boards.
* ``move_tail_reference`` on ``tests/test_torch_cuda.py:tail_trees`` (a tie
  of counts, no visited edge, u past the float32 running sum, either side
  of ``temperature_moves``, a win, a draw, a full column): each case plays
  the action it is built for, and a finished game is reset.
* The tail's action against JAX's plain ``_sample_from_counts``
  (``alphazero_tpu/search/pallas_fused.py``, no Pallas call) on the same
  counts, policy, u and move counts, BITWISE.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.envs import make_env
from alphazero_tpu.envs.core import EnvState
from alphazero_tpu.search.pallas_fused import _sample_from_counts
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.search import fused
from tests.test_torch_cuda import (TAIL_CASES, TAIL_TEMPERATURE, WALK_GAMES,
                                   check_root_cases, check_tail_cases,
                                   root_trees, tail_records, tail_trees)

CPU = torch.device("cpu")
B = 20


@pytest.mark.parametrize("game", WALK_GAMES)
def test_root_cases_plain(game):
    """The plain tree init gives each case of ``root_trees`` its legal
    actions, with the noise mixed in and without; without it the legal
    priors are the quantized probabilities, and the noise moves them."""
    env = make_tenv(game)
    cfg, tree, probs, value, noise, board = root_trees(env, B, 31, CPU)
    rows = []
    for noise_m in (noise, None):
        tp = tree.clone()
        fused.root_init_reference(env, cfg, tp, probs, value, noise_m, board)
        check_root_cases(env, tp, tree, value)
        rows.append(tp.prior[:, 0])
    legal = tp.child[:, 0] != fused.ILLEGAL
    assert torch.equal(rows[1][legal], fused.qprior(probs)[legal])
    assert not torch.equal(rows[0], rows[1])


@pytest.mark.parametrize("game", WALK_GAMES)
def test_root_legal_mask_matches_jax_valid_mask(game):
    """The root's legal edges are the JAX env's ``valid_mask`` of the same
    boards (as live games) in every case of ``root_trees``."""
    env, jenv = make_tenv(game), make_env(game)
    cfg, tree, probs, value, _, board = root_trees(env, B, 31, CPU)
    fused.root_init_reference(env, cfg, tree, probs, value, None, board)
    stones = board.reshape(B, -1).sum(-1).to(torch.int32).numpy()
    states = EnvState(board=jnp.asarray(board.numpy()),
                      current_player=jnp.asarray(stones % 2),
                      move_count=jnp.asarray(stones),
                      winner=jnp.full((B,), -1, jnp.int32),
                      done=jnp.zeros((B,), bool))
    want = np.asarray(jax.vmap(jenv.valid_mask)(states))
    np.testing.assert_array_equal(
        (tree.child[:, 0] != fused.ILLEGAL).numpy(), want)


def _tail(game):
    env = make_tenv(game)
    cfg, tree, u, board, player, mc = tail_trees(env, B, 32, CPU)
    out = (board.clone(), player.clone(), mc.clone(),
           tail_records(B, env.action_dim, CPU))
    fused.move_tail_reference(env, cfg, tree, u, *out)
    return env, tree, u, board, mc, out


@pytest.mark.parametrize("game", WALK_GAMES)
def test_tail_cases_plain(game):
    """The plain tail plays what each case of ``tail_trees`` is built for
    and records the move before it: player, move count and root Q."""
    env, tree, u, board, mc, out = _tail(game)
    check_tail_cases(env, board, *out)
    rec = out[3]
    assert torch.equal(rec["t"], mc)
    root_q = tree.val[:, 0] / torch.clamp(torch.floor(tree.visit[:, 0]),
                                          min=1.0)
    assert torch.equal(rec["root_q"], root_q)


@pytest.mark.parametrize("game", WALK_GAMES)
def test_tail_action_bitwise_vs_jax_sample_from_counts(game):
    """The tail's action is JAX's ``_sample_from_counts`` on the same
    counts, policy, u and move counts: the inverse-CDF sample, both of its
    fallbacks and the switch at ``temperature_moves``."""
    env, tree, u, board, mc, out = _tail(game)
    ch0 = tree.child[:, 0].long()
    counts = torch.where(ch0 >= 0, torch.floor(
        tree.visit[torch.arange(B)[:, None], ch0.clamp(min=0)]), 0.0)
    rec = out[3]
    jcfg = JaxMCTSConfig(temperature_moves=TAIL_TEMPERATURE)
    want = _sample_from_counts(
        jcfg, jnp.asarray(counts.numpy().T),
        jnp.asarray(rec["policy"].numpy().T), jnp.asarray(u.numpy()[None]),
        jnp.asarray(mc.numpy()[None]))
    np.testing.assert_array_equal(rec["action"].numpy(),
                                  np.asarray(want)[0])
    case = np.arange(B) % TAIL_CASES
    sampled = mc.numpy() < TAIL_TEMPERATURE
    assert sampled[case == 3].all() and not sampled[case == 4].any()
