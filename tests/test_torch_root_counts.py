"""The move search's two ends: the root counts and the tree init.

* ``root_counts_reference`` on the trees of the card-only test
  (``tests/test_torch_cuda.py:count_trees``: a finished root, illegal and
  unvisited edges, expanded bits, a tie, one edge, edges past the first 32
  actions, a real search): each case gives the counts, policy and root Q
  it is built for.
* The same counts and root Q against JAX's plain ``_root_counts``
  (``alphazero_tpu/search/pallas_fused.py``, no Pallas call) on the same
  tree, and the policy against ``run_mcts_fused``'s formula, BITWISE.
* ``move_root_init_reference`` on ``tests/test_torch_cuda.py:dirty_trees``
  (visit and val 7.0, sentinel edges) at N = 401 and 201: every visit and
  val element and the root's edges rewritten, the rows below kept.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.envs import make_env
from alphazero_tpu.search.pallas_fused import _root_counts
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.search import fused
from tests.test_torch_cuda import (COUNT_CASES, WALK_GAMES, check_count_cases,
                                   check_dirty_init, count_trees, dirty_trees)

CPU = torch.device("cpu")
B = 3 * COUNT_CASES


@pytest.mark.parametrize("game", WALK_GAMES)
def test_root_counts_cases_plain(game):
    """The plain root counts give each case of ``count_trees`` its counts,
    policy and root Q."""
    env = make_tenv(game)
    tree = count_trees(env, B, 41, CPU)
    check_count_cases(env, *fused.root_counts_reference(tree))


@pytest.mark.parametrize("game", WALK_GAMES)
def test_root_counts_bitwise_vs_jax_root_counts(game):
    """Counts and root Q are JAX's ``_root_counts`` (its one-hot gather
    over the (N, B) visits, children packed as child + 2 in (A, N, B)) on
    the same tree, and the policy is ``run_mcts_fused``'s
    ``counts / max(Σ, 1)`` of them, bit for bit."""
    env, jenv = make_tenv(game), make_env(game)
    tree = count_trees(env, B, 41, CPU)
    counts, policy, root_q = fused.root_counts_reference(tree)
    pc = (tree.child + 2).to(torch.float32).permute(2, 1, 0)
    counts_f, rootq = _root_counts(
        jenv, jnp.asarray(tree.visit.numpy().T), jnp.asarray(pc.numpy()),
        jnp.asarray(tree.val.numpy().T))
    jcounts = counts_f.T.astype(jnp.int32)
    total = jnp.maximum(jcounts.sum(axis=-1), 1).astype(jnp.float32)
    jpolicy = jcounts.astype(jnp.float32) / total[:, None]
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(policy.numpy(), np.asarray(jpolicy))
    np.testing.assert_array_equal(root_q.numpy(), np.asarray(rootq)[0])
    assert (counts.sum(-1) > 0).any() and (counts.sum(-1) == 0).any()


@pytest.mark.parametrize("S", [400, 200])
@pytest.mark.parametrize("game", WALK_GAMES)
def test_move_root_init_dirty_plain(game, S):
    """The plain tree init rewrites every visit and val element and the
    root's edges of a dirty tree and keeps the rows below; live and
    finished games both occur, and legal and illegal root edges."""
    env = make_tenv(game)
    tree, prior, value, live = dirty_trees(env, B, S, 42, CPU)
    tp = tree.clone()
    fused.move_root_init_reference(tp, prior, value, live)
    check_dirty_init(tp, tree, prior, value, live)
    ok = tp.child[:, 0] == fused.NO_CHILD
    assert live.any() and (~live).any() and ok.any() and (~ok[live]).any()
