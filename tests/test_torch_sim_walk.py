"""The per-simulation engine's step: its tie and edge cases and its launch
geometry.

* ``sim_geometry`` (the launch geometry of ``az_sim_step`` and
  ``az_sim_flush``: a group of G lanes per game, G from the action count,
  up to 256 actions) for every action count the kernels take.
* ``sim_step_reference`` and ``flush_reference`` on the trees of the
  card-only test (``tests/test_torch_cuda.py:sim_trees``: tied fresh roots,
  gomoku's centre opening, a walk cut at its cap, a terminal child, a
  finished root, a win in one): the walk finds what each case holds and the
  next step flushes each kind of simulation.
* One step of ``sim_step_reference`` (and one ``flush_reference``) against
  JAX's ``make_sim_step(..., interpret=True)`` (the Pallas ``_sim_kernel``
  and ``_flush_kernel``, arrays transposed to its games-in-lanes layout)
  BITWISE on those trees, at connect4 and gomoku9: with nothing to flush
  (stale state carried in) and flushing the previous step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig
from alphazero_tpu.envs import make_env
from alphazero_tpu.search.pallas_mcts import make_sim_step
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.search import sim
from alphazero_tpu_torch.search.tree import NEG
from tests.test_torch_cuda import (SIM_CASES, SIM_GAMES, check_sim_cases,
                                   sim_trees, win_in_one)

CPU = torch.device("cpu")


@pytest.mark.parametrize("A,G,E", [
    (1, 8, 1), (7, 8, 1), (8, 8, 1), (9, 16, 1), (16, 16, 1), (17, 32, 4),
    (49, 32, 4), (81, 32, 4), (128, 32, 4), (129, 32, 8), (225, 32, 8),
    (256, 32, 8)])
def test_sim_geometry(A, G, E):
    """G is the smallest of 8, 16 and 32 that holds A, else 32; a lane
    reads E edges, E·G ≥ A; a CTA of 128 lanes holds 128 / G games; the
    CTAs cover B games and no more."""
    assert sim.sim_group(A) == G
    for B in (1, 17, 128, 129, 256, 512):
        geo = sim.sim_geometry(B, A)
        games = geo["games_per_cta"]
        assert geo["lanes_per_game"] == G and geo["edges_per_lane"] == E
        assert E * G >= A
        assert games * G == geo["threads_per_cta"] == sim.SIM_THREADS
        assert (geo["ctas"] - 1) * games < B <= geo["ctas"] * games


def test_sim_geometry_of_the_presets_and_refusals():
    """connect4 four games a warp, tictactoe two, gomoku a warp each, up to
    gomoku15's 225 actions; what the kernels refuse raises."""
    want = {"connect4": 8, "tictactoe": 16, "gomoku9": 32, "gomoku15": 32}
    for game, G in want.items():
        assert sim.sim_group(make_tenv(game).action_dim) == G
    assert sim.sim_geometry(256, 225)["ctas"] == 64
    assert sim.sim_geometry(512, 7)["ctas"] == 32
    assert sim.sim_geometry(128, 9)["ctas"] == 16
    for A in (0, 257, 361):
        with pytest.raises(ValueError):
            sim.sim_group(A)
    with pytest.raises(ValueError):
        sim.sim_geometry(0, 7)


def _probs(env, B, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((B, env.action_dim), generator=g),
            torch.rand((B,), generator=g) * 2 - 1)


@pytest.mark.parametrize("game", SIM_GAMES)
def test_sim_cases_plain(game):
    """The plain step finds each case of ``sim_trees``; the next step
    flushes each kind of simulation: a win's new edge gets no priors and
    backs up 1 for the winner, a walk cut at its cap adds one visit per
    ply, a finished root backs up its terminal value."""
    env = make_tenv(game)
    B = 2 * SIM_CASES
    cfg, tree, st, slot = sim_trees(env, B, 21, CPU)
    before = tree.clone()
    probs, value = _probs(env, B, 1)
    sim.sim_step_reference(env, cfg, tree, st, probs, value, 0, slot)
    for f in ("stats", "prior", "children"):
        assert torch.equal(getattr(tree, f), getattr(before, f)), f
    check_sim_cases(env, st, before.prior[:, 0], slot)
    meta = st.meta.long().clone()
    path = st.path.long().clone()
    valid = st.valid.clone()
    sim.sim_step_reference(env, cfg, tree, st, probs, value, slot, slot + 1)
    case = torch.arange(B) % SIM_CASES
    win = case == 5
    act = win_in_one(env)[1]
    assert (tree.children[win, 0, act] == slot).all()
    assert (tree.prior[win, slot] == NEG).all()
    assert torch.equal(tree.stats[win, slot],
                       torch.tensor([[1.0, 1.0, 0.0]] * int(win.sum())))
    assert torch.equal(tree.stats[win, 0, :2],
                       before.stats[win, 0, :2] + torch.tensor([1.0, -1.0]))
    fresh = case <= 1
    assert (tree.stats[fresh, slot, 2] == 1).all()
    assert torch.equal(tree.prior[fresh, slot],
                       torch.where(valid[fresh], probs[fresh], NEG))
    for b in torch.nonzero(case == 2).flatten().tolist():
        d = int(meta[b, sim.M_DEPTH])
        nodes = path[b, :d].tolist() + [int(meta[b, sim.M_LEAF])]
        assert len(set(nodes)) == d + 1
        assert torch.equal(tree.stats[b, nodes, 0],
                           before.stats[b, nodes, 0] + 1.0)
    done = case == 4
    assert torch.equal(tree.stats[done, 0, 0], before.stats[done, 0, 0] + 1)


def _lanes(t):
    """A port array with games in rows → the JAX kernel's games in lanes."""
    t = torch.as_tensor(t)
    return jnp.asarray(t.permute(*reversed(range(t.dim()))).contiguous()
                       .numpy())


def _jax_state(tree, st, probs, value):
    return dict(
        stats=_lanes(tree.stats), prior=_lanes(tree.prior),
        children=_lanes(tree.children.float()), path=_lanes(st.path),
        pmeta=_lanes(st.meta.float()), pvalid=_lanes(st.valid.float()),
        pprobs=_lanes(probs), pvalue=_lanes(value[:, None]))


def _assert_tree_equal(jax_out, tree):
    stats, prior, children = (np.asarray(x) for x in jax_out[:3])
    np.testing.assert_array_equal(stats, _lanes(tree.stats))
    np.testing.assert_array_equal(prior, _lanes(tree.prior))
    np.testing.assert_array_equal(children, _lanes(tree.children.float()))


@pytest.mark.parametrize("flush", [False, True])
@pytest.mark.parametrize("game", ["connect4", "gomoku9"])
def test_sim_step_bitwise_vs_pallas_sim_kernel(game, flush):
    """One step of the plain version against JAX's ``_sim_kernel`` in
    interpret mode, bit for bit, on every case of ``sim_trees``: with
    nothing to flush, or flushing the previous step's simulation of each
    kind (then the last one through ``_flush_kernel``).  JAX's leaf column
    of ``meta`` holds the edge's child (-1) where the port's holds the new
    slot: its update takes the slot there."""
    tenv = make_tenv(game)
    B = 2 * SIM_CASES
    cfg, tree, st, slot = sim_trees(tenv, B, 21, CPU)
    probs, value = _probs(tenv, B, 2)
    prev, cur = 0, slot
    if flush:
        sim.sim_step_reference(tenv, cfg, tree, st, probs, value, 0, slot)
        probs, value = _probs(tenv, B, 3)
        prev, cur = slot, slot + 1
    jcfg = MCTSConfig(**dataclasses.asdict(cfg))
    sim_fn, flush_fn = make_sim_step(make_env(game), jcfg, B,
                                     st.path.shape[1], interpret=True)
    js = _jax_state(tree, st, probs, value)
    out = sim_fn(js["stats"], js["prior"], js["children"],
                 jnp.asarray(tree.root_board.reshape(B, 2, -1)
                             .permute(1, 2, 0).float().numpy()),
                 _lanes(tree.root_player[:, None]),
                 _lanes(tree.root_move_count[:, None]), js["path"],
                 js["pmeta"], js["pvalid"], js["pprobs"], js["pvalue"], prev)
    sim.sim_step_reference(tenv, cfg, tree, st, probs, value, prev, cur)
    _assert_tree_equal(out, tree)
    path, apath, meta, obs, valid = (np.asarray(x) for x in out[3:])
    np.testing.assert_array_equal(path, _lanes(st.path))
    np.testing.assert_array_equal(apath, _lanes(st.apath))
    want_meta = st.meta.clone()
    alloc = want_meta[:, sim.M_ALLOC] > 0
    want_meta[alloc, sim.M_LEAF] = -1
    np.testing.assert_array_equal(meta, _lanes(want_meta.float()))
    np.testing.assert_array_equal(obs, _lanes(st.obs.reshape(B, -1)))
    np.testing.assert_array_equal(valid, _lanes(st.valid.float()))
    if flush:
        probs, value = _probs(tenv, B, 4)
        js = _jax_state(tree, st, probs, value)
        out = flush_fn(js["stats"], js["prior"], js["children"], js["path"],
                       js["pmeta"], js["pvalid"], js["pprobs"], js["pvalue"],
                       cur)
        sim.flush_reference(tree, st, probs, value, cur)
        _assert_tree_equal(out, tree)
