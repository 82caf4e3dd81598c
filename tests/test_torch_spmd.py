"""The port's mesh programs and ``SpmdTrainer`` against the JAX package's
``parallel/spmd.py`` and ``training/spmd_loop.py``, on two CPU ranks of a
gloo group (``tests/test_torch_ranks.py``).

* The sharded chunk: JAX's ``make_sharded_selfplay(..., interpret=True)``
  over its CPU mesh (``data=2``) and the port's on two ranks, at connect4
  with B = 4 (2 a shard), S = 12, M = 12, three chunks, under the exact
  stub with no Dirichlet noise and greedy moves: each rank's slabs, board
  and ring equal JAX's shard bit for bit, and the counters equal JAX's
  replicated global ones.
* Ranks add no mixing: with Dirichlet noise and visit sampling, rank s's
  chunks equal the single-process ``selfplay_chunk`` on games slice s with
  rank s's generator (``fold_seed(seed, s)``), bit for bit.
* The warm-up gate (``tests/test_spmd_trainer.py``): the parameters stay
  bitwise as they were while a ring is empty, then move, equal on both
  ranks; ``make_super_step`` at connect4, whose 6 moves finish no game,
  leaves them as they were (``tests/test_spmd_fused.py``).
* ``SpmdTrainer`` end to end: one ``iterate(vanilla_eval=False)`` of a
  tiny tictactoe ResNet at data=2; each rank's ring holds games, the
  contender is bitwise equal on both ranks, and a checkpoint restores
  every rank's parameters, ring and generators bitwise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import alphazero_tpu.search.pallas_fused as F
from alphazero_tpu.config import (Config, MCTSConfig, ModelConfig,
                                  ReplayConfig, TrainConfig)
from alphazero_tpu.data import create_sharded
from alphazero_tpu.envs import make_env
from alphazero_tpu.models import build_model, init_params
from alphazero_tpu.parallel import make_mesh
from alphazero_tpu.parallel.spmd import make_sharded_selfplay
from alphazero_tpu.training.selfplay import init_selfplay
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.data import create as tcreate
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.parallel.mesh import Mesh
from alphazero_tpu_torch.parallel.spmd import fold_seed, init_rank_selfplay
from alphazero_tpu_torch.search.stub import exact_stub_evaluator
from alphazero_tpu_torch.training import init_selfplay as tinit_selfplay
from alphazero_tpu_torch.training import selfplay_chunk
from tests import test_torch_ranks as torch_ranks
from tests.test_pallas_fused import _exact_stub_forwards

B, S, M, CHUNKS, SEED = 4, 12, 12, 3, 1
CAPACITY = 42 * 16
MCTS = {"exact": dict(num_simulations=S, temperature_moves=0,
                      use_dirichlet=False),
        "noisy": dict(num_simulations=S, temperature_moves=6,
                      dirichlet_alpha=0.3)}


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    spec = dict(B=B, M=M, chunks=CHUNKS, capacity=CAPACITY, seed=SEED,
                mcts=MCTS)
    return torch_ranks.run(torch_ranks.chunks, 2,
                           tmp_path_factory.mktemp("chunks"), spec)


def test_sharded_chunk_matches_jax_shard_by_shard(chunks, monkeypatch):
    env = make_env("connect4")
    model = build_model(ModelConfig(family="dense", width=32, blocks=1),
                        env)
    params = init_params(model, env, jax.random.PRNGKey(0))
    monkeypatch.setattr(F, "_leaf_eval", _exact_stub_forwards(env)[0])
    cfg = Config(env="connect4", mcts=MCTSConfig(**MCTS["exact"]),
                 model=ModelConfig(family="dense", width=32, blocks=1),
                 replay=ReplayConfig(capacity=CAPACITY),
                 train=TrainConfig(selfplay_batch=B))
    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    sp = init_selfplay(env, B, jax.random.PRNGKey(SEED))
    buf = create_sharded(env, CAPACITY, 2)
    run = jax.jit(make_sharded_selfplay(env, model, cfg, mesh, M,
                                        interpret=True))
    for _ in range(CHUNKS):
        sp, buf = run(params, sp, buf)
    n = B // 2
    for s, rank in enumerate(chunks):
        got, sl = rank["exact"], slice(s * n, (s + 1) * n)
        want = {"traj_obs": sp.traj_obs[sl], "traj_policy":
                sp.traj_policy[sl], "t": sp.t[sl],
                "board": sp.env_state.board[sl],
                "player": sp.env_state.current_player[sl],
                "move_count": sp.env_state.move_count[sl],
                "games_done": sp.games_done, "env_steps": sp.env_steps,
                "results": sp.results,
                **{f"buffer.{k}": getattr(buf, k)[s] for k in (
                    "obs", "policy", "length", "winner", "cursor", "size")}}
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                          err_msg=f"rank {s}: {k}")
    assert int(sp.games_done) > 0
    assert all(int(r["exact"]["buffer.size"]) > 0 for r in chunks)


def test_ranks_add_no_mixing(chunks):
    env = make_tenv("connect4")
    cfg = tcfg.MCTSConfig(**MCTS["noisy"])
    rcfg = tcfg.ReplayConfig(capacity=CAPACITY)
    full = tinit_selfplay(env, B, SEED, "cpu")
    games = steps = 0
    results = torch.zeros(3, dtype=torch.int64)
    for s, rank in enumerate(chunks):
        n = B // 2
        sp = init_rank_selfplay(env, B, SEED, Mesh(2, 1, s, s, 0, None, None),
                                "cpu")
        sl = slice(s * n, (s + 1) * n)   # the rank's games: slice s
        for f in dataclasses.fields(sp.env_state):
            assert torch.equal(getattr(sp.env_state, f.name),
                               getattr(full.env_state, f.name)[sl]), f.name
        for k in ("traj_obs", "traj_policy", "t"):
            assert torch.equal(getattr(sp, k), getattr(full, k)[sl]), k
        assert sp.generator.initial_seed() == fold_seed(SEED, s)
        buf = tcreate(env, CAPACITY // 2, device="cpu")
        for _ in range(CHUNKS):
            sp, buf = selfplay_chunk(env, None, None, cfg, rcfg, sp, buf, M,
                                     evaluator=exact_stub_evaluator(env))
        for k, want in torch_ranks.state_of(sp, buf).items():
            if k not in ("games_done", "env_steps", "results"):  # global
                assert torch.equal(rank["noisy"][k], want), (s, k)
        games, steps = games + sp.games_done, steps + sp.env_steps
        results += sp.results
        assert sp.env_steps == n * M * CHUNKS
    assert not torch.equal(chunks[0]["noisy"]["traj_policy"],
                           chunks[1]["noisy"]["traj_policy"])
    for r in chunks:
        assert r["noisy"]["games_done"] == games
        assert r["noisy"]["env_steps"] == steps
        assert torch.equal(r["noisy"]["results"], results)


@pytest.fixture(scope="module")
def warmup(tmp_path_factory):
    return torch_ranks.run(torch_ranks.warmup, 2,
                           tmp_path_factory.mktemp("warmup"), {})


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_train_chunk_warmup_gate(warmup):
    for r in warmup:
        (ok0, p0, loss0), (ok1, p1, loss1), (ok2, p2, loss2) = r["trained"]
        assert (ok0, ok1, ok2) == (False, False, True)
        assert _same(p0, r["params"]) and _same(p1, r["params"])
        assert loss0 == loss1 == 0.0 and np.isfinite(loss2) and loss2 > 0
        assert not _same(p2, r["params"])
    assert _same(warmup[0]["trained"][2][1], warmup[1]["trained"][2][1])


def test_super_step_holds_the_learner_until_rings_fill(warmup):
    for r in warmup:
        st = r["super_step"]
        assert st["env_steps"] == 6 * 8 and st["ring_size"] == 0
        assert _same(st["params"], st["params_in"]) and st["loss"] == 0.0


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    run = tmp_path_factory.mktemp("run")
    return torch_ranks.run(torch_ranks.trainer, 2,
                           tmp_path_factory.mktemp("trainer"),
                           {"workdir": str(run)})


def test_spmd_trainer_iterates_over_two_rings(trainer):
    it = trainer[0]["iterate"]
    assert it["games"] >= 4 and it["env_steps"] > 0 and it["trained"]
    assert np.isfinite(it["loss"]) and it["steps"] > 0
    for k in ("games", "env_steps", "steps", "loss", "accepted",
              "gate_rate", "buffer_size", "results"):
        assert it[k] == trainer[1]["iterate"][k], k
    for r in trainer:
        assert r["ring_blocks"] == 1024 // 9 // 2 and r["ring_size"] > 0
        assert r["gate_score"] == trainer[0]["gate_score"]
    assert sum(r["ring_size"] for r in trainer) == min(
        it["games"], 2 * trainer[0]["ring_blocks"])
    assert _same(trainer[0]["params_best"], trainer[1]["params_best"])


def test_spmd_trainer_checkpoint_restores_every_rank(trainer):
    for r in trainer:
        assert r["restored"] and r["same_params"] and r["same_ring"]
        assert r["same_generators"] and r["same_counts"]
