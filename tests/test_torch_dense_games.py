"""The dense tower's searches off connect4: tictactoe and gomoku.

* The plain whole-chunk search (``selfplay_chunk_reference``) against the
  JAX package's ``run_selfplay_chunk_fused(..., interpret=True)`` BITWISE
  under the exact stub evaluator, at tictactoe (A=9), gomoku 7×7 (A=49) and
  9×9 (A=81), B=4, S=24: empty boards (the centre rule), boards one move
  from a win, and one case with Dirichlet noise and temperature sampling
  (JAX's draws handed to the port).
* The plain move search against JAX's ``run_mcts_fused(interpret=True)``
  bitwise at tictactoe and gomoku, with won and drawn roots among live ones.
* ``dense_forward_reference`` against the Pallas ``_dense_forward`` at
  gomoku9 (A=81, width 64, 1 block): 95% of outputs within 1e-5, all within
  5e-3 (the tolerance of ``tests/test_torch_dense.py``, for the same
  reason: bf16 rounding of float32 sums taken in another order).
* The engine gate ``supports_chunk``: the runner and ``run_mcts`` take the
  chunk and move searches where it accepts, ``selfplay_step`` and the
  per-simulation engine where it refuses (510 simulations, a gomoku15 dense
  tower), and a tiny ``gomoku9-dense`` ``Trainer.collect`` goes through
  the chunk.
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
from alphazero_tpu_torch.models import init_params as tinit
from alphazero_tpu_torch.models import make_eval_fn as make_teval_fn
from alphazero_tpu_torch.models import params_from_flax
from alphazero_tpu_torch.search import fused
from alphazero_tpu_torch.search.mcts import run_mcts
from alphazero_tpu_torch.search.stub import drawn_board, exact_stub_evaluator
from alphazero_tpu_torch.training import Trainer, selfplay
from tests.test_pallas_fused import _exact_stub_forwards
from tests.test_torch_chunk import KEYS, _jax_noise, _port_cfg

GAMES = ("tictactoe", "gomoku", "gomoku9")


def near_win(game):
    """A board where player 0, to move, completes a line with one stone,
    and the move count it was reached in: tictactoe X X . / O O . / . . .;
    gomoku four stones of player 0 on the middle row (the fifth cell
    free), player 1's four on the row below, not in a line."""
    env = make_tenv(game)
    R, C = env.rows, env.cols
    b = np.zeros((2, R, C), np.int8)
    if game == "tictactoe":
        b[0, 0, :2] = 1
        b[1, 1, :2] = 1
        return b, 4
    r = R // 2
    b[0, r, 1:5] = 1
    b[1, r + 1, [0, 2, 4, 6]] = 1
    return b, 8


def chunk_roots(game):
    """Game 0 an empty board (player 0), game 1 near a win, game 2 an
    empty board with player 1 to move, game 3 near a win."""
    env = make_tenv(game)
    empty = np.zeros((2, env.rows, env.cols), np.int8)
    nw, mc = near_win(game)
    boards = np.stack([empty, nw, empty, nw])
    return (boards, np.array([0, 0, 1, 0], np.int32),
            np.array([0, mc, 0, mc], np.int32))


def _dense(game, width=64, blocks=1, seed=0):
    env = make_env(game)
    model = build_model(ModelConfig(family="dense", width=width,
                                    blocks=blocks), env)
    params = init_params(model, env, jax.random.PRNGKey(seed))
    tenv = make_tenv(game)
    tmodel = build_tmodel(tcfg.ModelConfig(family="dense", width=width,
                                           blocks=blocks), tenv)
    return env, model, params, tenv, tmodel, params_from_flax(
        jax.tree.map(np.asarray, params))


MOVES = {"tictactoe": 3, "gomoku": 3, "gomoku9": 2}
CHUNK_CASES = [(g, False) for g in GAMES] + [("gomoku", True)]


@pytest.mark.parametrize("game,dirichlet", CHUNK_CASES,
                         ids=[f"{g}{'-dirichlet' if d else ''}"
                              for g, d in CHUNK_CASES])
def test_chunk_reference_bitwise_vs_jax_chunk_kernel(monkeypatch, game,
                                                     dirichlet):
    env, model, params, tenv, tmodel, tparams = _dense(game)
    kernel_stub, _ = _exact_stub_forwards(env)
    monkeypatch.setattr(F, "_leaf_eval", kernel_stub)
    cfg = MCTSConfig(num_simulations=24, temperature_moves=0,
                     use_dirichlet=False)
    if dirichlet:
        cfg = dataclasses.replace(cfg, use_dirichlet=True,
                                  dirichlet_alpha=0.1, temperature_moves=8)
    boards, players, mcs = chunk_roots(game)
    M, key = MOVES[game], jax.random.PRNGKey(7)
    want = jax.tree.map(np.asarray, F.run_selfplay_chunk_fused(
        env, model, params, jnp.asarray(boards), jnp.asarray(players),
        jnp.asarray(mcs), key, cfg, M, interpret=True))
    noise, unif = _jax_noise(key, cfg, M, env.action_dim, boards.shape[0])
    got = fused.selfplay_chunk_reference(
        tenv, tmodel, tparams, torch.as_tensor(boards),
        torch.as_tensor(players), torch.as_tensor(mcs), _port_cfg(cfg), M,
        noise=torch.as_tensor(noise), unif=torch.as_tensor(unif),
        evaluator=exact_stub_evaluator(tenv))
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the near-win games won on their first move; the empty boards opened
    # in the centre where the rules force it
    assert want["done"][0, [1, 3]].all()
    assert (want["winner"][0, [1, 3]] == 0).all()
    if game != "tictactoe":
        centre = (env.rows // 2) * env.cols + env.cols // 2
        assert (want["action"][0, [0, 2]] == centre).all()
    if dirichlet:
        assert (want["action"] != want["policy"].argmax(-1)).any()


def move_roots(game):
    """Live roots (empty, near a win, one stone of each player), a won game
    (player 0's five / three in a row, player 1 to move) and a drawn one."""
    tenv = make_tenv(game)
    R, C = tenv.rows, tenv.cols
    empty = np.zeros((2, R, C), np.int8)
    nw, mc = near_win(game)
    two = empty.copy()
    two[0, R // 2, C // 2] = 1
    two[1, R // 2 - 1, C // 2] = 1
    won = nw.copy()
    if game == "tictactoe":
        won[0, 0, 2] = 1
    else:
        won[0, R // 2, 5] = 1
    drawn = drawn_board(tenv).numpy()
    boards = np.stack([empty, nw, two, won, drawn, nw])
    players = np.array([0, 0, 0, 1, 0, 0], np.int32)
    mcs = np.array([0, mc, 2, mc + 1, tenv.max_moves, mc], np.int32)
    dones = np.array([0, 0, 0, 1, 1, 0], bool)
    return boards, players, mcs, dones


@pytest.mark.parametrize("game", ["tictactoe", "gomoku"])
def test_move_search_bitwise_vs_jax_move_kernel(monkeypatch, game):
    env, model, params, tenv, _, _ = _dense(game)
    kernel_stub, xla_eval = _exact_stub_forwards(env)
    monkeypatch.setattr(F, "_leaf_eval", kernel_stub)
    cfg = MCTSConfig(num_simulations=24, use_dirichlet=True,
                     dirichlet_alpha=0.3)
    boards, players, mcs, dones = move_roots(game)
    key = jax.random.PRNGKey(5)
    want = jax.tree.map(np.asarray, F.run_mcts_fused(
        env, model, params, xla_eval, jnp.asarray(boards),
        jnp.asarray(players), jnp.asarray(mcs), jnp.asarray(dones), key, cfg,
        interpret=True))
    noise = np.array(jax.random.dirichlet(
        key, jnp.full((env.action_dim,), cfg.dirichlet_alpha, jnp.float32),
        shape=(boards.shape[0],)))
    stub = exact_stub_evaluator(tenv)
    got = fused.move_search_reference(
        tenv, None, None, lambda o: stub(o.reshape(o.shape[0], -1)),
        *(torch.as_tensor(a) for a in (boards, players, mcs, dones)),
        _port_cfg(cfg), noise=torch.as_tensor(noise), evaluator=stub)
    for name in ("visit_counts", "policy", "root_q"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)
    counts = want.visit_counts
    np.testing.assert_array_equal(counts.sum(-1)[~dones], 23)
    np.testing.assert_array_equal(counts.sum(-1)[dones], 0)
    # the won root backs up its win on every simulation, the drawn one 0
    assert got.root_q[3] == np.float32(23) / np.float32(24)
    assert got.root_q[4] == 0.0
    if game == "gomoku":       # the centre alone on an empty board
        centre = (env.rows // 2) * env.cols + env.cols // 2
        assert counts[0, centre] == 23


def test_dense_forward_reference_matches_pallas_forward_at_81_actions():
    env, model, params, tenv, tmodel, tparams = _dense("gomoku9", seed=1)
    B = 32
    rng = np.random.RandomState(2)
    boards = (rng.rand(B, 2, 9, 9) < 0.25).astype(np.int8)
    boards[:, 1] *= 1 - boards[:, 0]
    obs = np.array(jax.vmap(env.observation_from_board)(
        jnp.asarray(boards), jnp.zeros(B, jnp.int32)),
        np.float32).reshape(B, -1)
    want_p, want_v = F._dense_forward(env, model,
                                      F._pack_dense_params(model, params),
                                      jnp.asarray(obs.T),
                                      jnp.asarray(F._game_tables(env)["W"]))
    p, v = fused.dense_forward_reference(
        torch.as_tensor(obs), fused.pack_dense_params(tmodel, tparams))
    assert p.shape == (B, 81)
    for got, want in ((p.numpy(), np.asarray(want_p).T),
                      (v.numpy(), np.asarray(want_v)[0])):
        diff = np.abs(got - want)
        assert diff.max() <= 5e-3, diff.max()
        assert (diff <= 1e-5).mean() >= 0.95, np.sort(diff.ravel())[-10:]


@pytest.mark.parametrize("game", ["connect4", "tictactoe", "gomoku",
                                  "gomoku9", "gomoku15"])
def test_drawn_board_is_full_and_drawn(game):
    env = make_tenv(game)
    b = drawn_board(env)
    assert b.shape == (2, env.rows, env.cols)
    assert int(b.sum()) == env.max_moves == env.rows * env.cols
    assert int(b[0].sum()) - int(b[1].sum()) == env.max_moves % 2
    assert not env.won_batch(b[None, 0]) and not env.won_batch(b[None, 1])


def test_dense_plan_takes_gomoku9_dense():
    """gomoku9-dense: D=512, F=2 planes of 81 cells and 140 lines, so the
    stem's input is 442 wide (Kp=448), value_fc 128, A=81: every tile fits
    one CTA's shared memory, and the planner takes the
    self-play and gate batches."""
    from tests.test_torch_dense import H100_SLOTS
    tenv = make_tenv("gomoku9")
    tmodel = build_tmodel(tcfg.preset("gomoku9-dense").model, tenv)
    assert tmodel.in_features == 442
    assert fused.dense_tiles(512, 448, 128, 81) == (16, 32, 48)
    assert [fused.dense_smem_bytes(g, 512, 448, 128, 81)
            for g in (16, 32, 48)] == [177_792, 222_464, 217_216]
    for B in (1, 17, 128, 129, 256):
        plan = fused.dense_plan(B, 512, 448, 128, 81, H100_SLOTS)
        assert plan["games_per_tile"] * plan["tiles"] >= B
        assert plan["smem_bytes"] <= fused.SMEM_LIMIT


def _gate_cfg(game, model, **mcts):
    tenv = make_tenv(game)
    return tenv, build_tmodel(model, tenv), tcfg.MCTSConfig(**mcts)


def test_supports_chunk_gates():
    """JAX's semantic gates and the kernels' capacity, from the env, the
    model and the config alone (the same answer on every device)."""
    dense = tcfg.ModelConfig(family="dense", width=64, blocks=1)
    ok = [_gate_cfg(g, dense) for g in ("connect4", "tictactoe", "gomoku",
                                        "gomoku9")]
    assert all(fused.supports_chunk(*a) for a in ok)
    tenv, tmodel, _ = ok[0]
    for mcts in (dict(num_simulations=510), dict(leaf_batch=2)):
        assert not fused.supports_chunk(tenv, tmodel, tcfg.MCTSConfig(**mcts))
    assert fused.supports_chunk(tenv, tmodel,
                                tcfg.MCTSConfig(num_simulations=509))
    # a ResNet, a width the forward kernel does not split, gomoku15 (225
    # actions, a stem too wide for shared memory)
    refused = [_gate_cfg("connect4", tcfg.ModelConfig(family="resnet",
                                                      channels=8, blocks=1)),
               _gate_cfg("connect4", tcfg.ModelConfig(family="dense",
                                                      width=32, blocks=1)),
               _gate_cfg("gomoku15", tcfg.ModelConfig(family="dense",
                                                      width=512, blocks=2))]
    assert not any(fused.supports_chunk(*a) for a in refused)


def _runner_calls(monkeypatch, game, model_cfg, mcts_cfg):
    """Which of ``selfplay_chunk`` / ``selfplay_step`` one call of the
    runner makes (both monkeypatched: no search runs)."""
    calls = []
    monkeypatch.setattr(selfplay, "selfplay_chunk",
                        lambda *a, **k: calls.append("chunk") or (a[5], a[6]))
    monkeypatch.setattr(selfplay, "selfplay_step",
                        lambda *a, **k: calls.append("step") or (a[3], a[4]))
    tenv = make_tenv(game)
    tmodel = build_tmodel(model_cfg, tenv)
    params = tinit(tmodel, torch.Generator().manual_seed(0))
    runner = selfplay.make_selfplay_runner(tenv, tmodel, mcts_cfg,
                                           tcfg.ReplayConfig(), 2)
    runner(params, "sp", "buffer")
    return calls


def test_runner_at_510_simulations_plays_move_by_move(monkeypatch):
    """Fault 1: the packed-edge bound ``num_simulations + 2 < 512`` holds in
    the runner as in JAX's ``supports_selfplay_fused``: 509 simulations take
    the chunk, 510 take ``selfplay_step``."""
    dense = tcfg.ModelConfig(family="dense", width=64, blocks=1)
    assert _runner_calls(monkeypatch, "connect4", dense,
                         tcfg.MCTSConfig(num_simulations=509)) == ["chunk"]
    assert _runner_calls(monkeypatch, "connect4", dense,
                         tcfg.MCTSConfig(num_simulations=510)) == ["step",
                                                                   "step"]


def test_gomoku15_dense_tower_plays_move_by_move(monkeypatch):
    """A gomoku15 dense tower (its stem does not fit a CTA's shared memory)
    goes to ``selfplay_step``, and its searches to the per-simulation
    engine; gomoku9's takes the chunk."""
    dense = tcfg.ModelConfig(family="dense", width=512, blocks=1)
    assert _runner_calls(monkeypatch, "gomoku15", dense,
                         tcfg.MCTSConfig()) == ["step", "step"]
    assert _runner_calls(monkeypatch, "gomoku9", dense,
                         tcfg.MCTSConfig()) == ["chunk"]
    from alphazero_tpu_torch.search import sim
    used = []
    monkeypatch.setattr(sim, "run_mcts_sim",
                        lambda *a, **k: used.append("sim"))
    monkeypatch.setattr(fused, "run_mcts_fused",
                        lambda *a, **k: used.append("fused"))
    for game in ("gomoku15", "gomoku9"):
        tenv = make_tenv(game)
        tmodel = build_tmodel(dense, tenv)
        eval_fn = make_teval_fn(tmodel, {})
        z = torch.zeros(1, dtype=torch.int32)
        run_mcts(tenv, eval_fn, torch.zeros((1, 2, tenv.rows, tenv.cols),
                                            dtype=torch.int8), z, z,
                 torch.zeros(1, dtype=torch.bool), tcfg.MCTSConfig(),
                 device="cpu")
    assert used == ["sim", "fused"]


def test_gomoku9_dense_collect_on_cpu_goes_through_the_chunk(monkeypatch):
    """A tiny ``gomoku9-dense`` (width 64, 1 block, 6 simulations, 4
    games): ``Trainer.collect`` runs the chunk search, every move is legal
    (one stone per move, the first in the centre) and every decided game
    ends with a five of its winner."""
    base = tcfg.preset("gomoku9-dense")
    cfg = dataclasses.replace(
        base, mcts=dataclasses.replace(base.mcts, num_simulations=6),
        model=tcfg.ModelConfig(family="dense", width=64, blocks=1),
        replay=tcfg.ReplayConfig(capacity=81 * 8),
        train=dataclasses.replace(base.train, selfplay_batch=4,
                                  selfplay_chunk_steps=27, seed=1))
    chunks = []
    real = selfplay.run_selfplay_chunk
    monkeypatch.setattr(selfplay, "run_selfplay_chunk",
                        lambda *a, **k: chunks.append(a[-1]) or real(*a, **k))
    tr = Trainer(cfg, device="cpu")
    m = tr.collect(games_target=1)
    assert chunks and all(M == 27 for M in chunks)
    assert m["env_steps"] == 27 * 4 * len(chunks)
    size = int(tr.buffer.size)
    assert size >= 1 and m["games"] >= 1
    env = tr.env
    lens = tr.buffer.length[:size].numpy()
    obs = tr.buffer.obs[:size].numpy().astype(np.int64)
    for g in range(size):
        stones = obs[g, :lens[g], :2].reshape(lens[g], -1).sum(-1)
        np.testing.assert_array_equal(stones, np.arange(lens[g]))
        assert obs[g, 1, :2, 4, 4].sum() == 1       # the opening: the centre
    # a decided game's last position is one move from its winner's line
    winners = tr.buffer.winner[:size].numpy()
    assert ((winners == -1) | (lens >= 9)).all()
