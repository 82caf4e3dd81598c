"""Rank programs of the port's multi-process tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_spmd.py``); this
module holds no test of its own.

Each function runs on every rank of a gloo group that
``alphazero_tpu_torch.parallel.distributed.launch`` starts on the CPU and
saves what the tests check to ``<out>/rank<r>.pt``.  Spawned ranks import
this module, so it imports no JAX.
"""

import dataclasses
import os

import torch
import torch.distributed as dist
from torch.func import functional_call

from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.data import add_games, create_sharded, shard_of
from alphazero_tpu_torch.envs import make_env
from alphazero_tpu_torch.models import build_model, init_params
from alphazero_tpu_torch.parallel import (TPViT, make_mesh,
                                          make_sharded_selfplay,
                                          make_super_step, make_train_chunk,
                                          shard_vit_params)
from alphazero_tpu_torch.parallel.distributed import launch
from alphazero_tpu_torch.parallel.spmd import init_rank_selfplay
from alphazero_tpu_torch.search.stub import exact_stub_evaluator
from alphazero_tpu_torch.training import init_selfplay, learner
from alphazero_tpu_torch.training.spmd_loop import GENERATORS, SpmdTrainer
from alphazero_tpu_torch.utils.metrics import MetricsLogger

TIMEOUT = 120     # s a collective may wait before the rank fails


def run(fn, world, out, spec):
    """``fn(out, spec)`` on ``world`` CPU ranks; the ranks' saved results
    in rank order."""
    launch(fn, world, str(out), spec, device="cpu", timeout=TIMEOUT)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _save(out, **results):
    torch.save(results, os.path.join(out, f"rank{dist.get_rank()}.pt"))


def state_of(sp, buf):
    """A self-play state's and a ring's tensors, by name."""
    return {"traj_obs": sp.traj_obs, "traj_policy": sp.traj_policy,
            "t": sp.t, "board": sp.env_state.board,
            "player": sp.env_state.current_player,
            "move_count": sp.env_state.move_count,
            "games_done": sp.games_done, "env_steps": sp.env_steps,
            "results": sp.results,
            **{f"buffer.{f.name}": getattr(buf, f.name)
               for f in dataclasses.fields(buf)}}


def chunks(out, spec):
    """``spec["chunks"]`` chunks of ``make_sharded_selfplay`` under the
    exact stub at connect4, for each search config in ``spec["mcts"]``."""
    mesh = make_mesh(2)
    env = make_env("connect4")
    res = {}
    for name, mcts in spec["mcts"].items():
        cfg = tcfg.Config(mcts=tcfg.MCTSConfig(**mcts),
                          replay=tcfg.ReplayConfig(capacity=spec["capacity"]))
        sp = init_rank_selfplay(env, spec["B"], spec["seed"], mesh, "cpu")
        buf = shard_of(create_sharded(env, spec["capacity"], 2, "cpu"),
                       mesh.data_index)
        step = make_sharded_selfplay(env, None, cfg, mesh, spec["M"],
                                     evaluator=exact_stub_evaluator(env))
        for _ in range(spec["chunks"]):
            sp, buf = step(None, sp, buf)
        res[name] = state_of(sp, buf)
    _save(out, **res)


def dp_step(out, spec):
    """One data-parallel Adam step: each of two ranks takes half of
    ``spec``'s batch."""
    mesh = make_mesh(2)
    model = build_model(tcfg.ModelConfig(**spec["model"]),
                        make_env(spec["env"]))
    n = spec["obs"].shape[0] // 2
    sl = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    ps = learner.leaf_copies(spec["params"])
    opt = learner.make_optimizer(tcfg.TrainConfig(), ps)
    m = learner.train_step(model, ps, opt, spec["obs"][sl], spec["pol"][sl],
                           spec["val"][sl], spec["l2"], None, mesh)
    _save(out, grads={k: p.grad for k, p in ps.items()},
          params={k: p.detach() for k, p in ps.items()}, metrics=m)


def tp_vit(out, spec):
    """The ViT on a data=2, model=2 mesh: its split forward on the whole
    batch, with and without dropout, and one learner step on this data
    rank's half of the batch (gradients averaged over the data group)."""
    mesh = make_mesh(2, 2)
    model = build_model(tcfg.ModelConfig(**spec["model"]),
                        make_env(spec["env"]))
    tp = TPViT(model, mesh)
    local = shard_vit_params(spec["params"], mesh)
    obs = spec["obs"]
    logits, value = functional_call(tp, local, (obs,))
    gen = torch.Generator().manual_seed(spec["seed"])
    drop = functional_call(tp, local, (obs,), {"dropout_generator": gen})
    n = obs.shape[0] // 2
    sl = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    ps = learner.leaf_copies(local)
    opt = learner.make_optimizer(tcfg.TrainConfig(), ps)
    m = learner.train_step(tp, ps, opt, obs[sl], spec["pol"][sl],
                           spec["val"][sl], spec["l2"], None, mesh)
    _save(out, logits=logits, value=value, drop=drop, metrics=m,
          grads={k: p.grad for k, p in ps.items()},
          index=(mesh.data_index, mesh.model_index))


def _tictactoe_cfg(**train):
    return tcfg.Config(
        env="tictactoe",
        mcts=tcfg.MCTSConfig(num_simulations=8, temperature_moves=2,
                             dirichlet_alpha=0.35),
        model=tcfg.ModelConfig(family="resnet", channels=8, blocks=1,
                               compute_dtype="float32"),
        replay=tcfg.ReplayConfig(capacity=1024),
        train=tcfg.TrainConfig(**{"batch_size": 32, "selfplay_batch": 16,
                                  "games_per_iter": 4, "gate_games": 8,
                                  **train}))


def _one_game(env, buf):
    L, A = env.max_moves, env.action_dim
    return add_games(buf, torch.zeros((1, L, env.feature_dim, env.rows,
                                       env.cols), dtype=torch.int8),
                     torch.full((1, L, A), 1.0 / A),
                     torch.tensor([3]), torch.tensor([0]),
                     torch.tensor([True]))


def warmup(out, spec):
    """The learner's warm-up gate: two train chunks of two steps while both
    rings are empty and while only rank 0's holds a game, then one with a
    game in each; and ``make_super_step`` at connect4, whose 6 moves
    finish no game."""
    mesh = make_mesh(2)
    cfg = _tictactoe_cfg()
    env = make_env(cfg.env)
    model = build_model(cfg.model, env)
    params = init_params(model, torch.Generator().manual_seed(0))
    buf = shard_of(create_sharded(env, 8 * 16 * env.max_moves, 2, "cpu"),
                   mesh.data_index)
    train = make_train_chunk(env, model, cfg, mesh, 2, device="cpu")
    gen = torch.Generator().manual_seed(1 + mesh.data_index)
    ps = learner.leaf_copies(params)
    opt = learner.make_optimizer(cfg.train, ps)
    trained = []
    for stage in range(3):
        if (stage, mesh.data_index) in ((1, 0), (2, 1)):
            buf = _one_game(env, buf)
        metrics, ok = train(ps, opt, buf, gen, None, 2)
        trained.append((ok, {k: v.detach().clone() for k, v in ps.items()},
                        float(metrics.loss)))

    c4 = tcfg.Config(mcts=tcfg.MCTSConfig(num_simulations=12,
                                          temperature_moves=2),
                     model=tcfg.ModelConfig(family="dense", width=64,
                                            blocks=1,
                                            compute_dtype="float32"),
                     replay=tcfg.ReplayConfig(capacity=42 * 64),
                     train=tcfg.TrainConfig(batch_size=16, selfplay_batch=8))
    env4 = make_env("connect4")
    model4 = build_model(c4.model, env4)
    p4 = init_params(model4, torch.Generator().manual_seed(0))
    step = make_super_step(env4, model4, c4, mesh, 6, 2, device="cpu")
    sp = init_rank_selfplay(env4, 8, 1, mesh, "cpu")
    buf4 = shard_of(create_sharded(env4, c4.replay.capacity, 2, "cpu"),
                    mesh.data_index)
    p5, sp, buf4, m5 = step(p4, sp, buf4, gen, None)
    _save(out, params=params, trained=trained,
          super_step={"params_in": p4, "params": p5,
                      "env_steps": int(sp.env_steps),
                      "ring_size": int(buf4.size), "loss": float(m5.loss)})


def trainer(out, spec):
    """One ``SpmdTrainer.iterate(vanilla_eval=False)`` at data=2, a
    checkpoint, and a second trainer restoring it."""
    cfg = _tictactoe_cfg()
    quiet = MetricsLogger(stdout=False)
    tr = SpmdTrainer(cfg, device="cpu", workdir=spec["workdir"],
                     logger=quiet)
    it = tr.iterate(vanilla_eval=False)
    tr.save_checkpoint()
    tr2 = SpmdTrainer(cfg, device="cpu", workdir=spec["workdir"],
                      logger=quiet)
    restored = tr2.restore_checkpoint()

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a) and set(a) == set(b)

    ring = {f.name: getattr(tr.buffer, f.name)
            for f in dataclasses.fields(tr.buffer)}
    ring2 = {f.name: getattr(tr2.buffer, f.name)
             for f in dataclasses.fields(tr2.buffer)}
    _save(out, iterate=it, restored=restored,
          same_params=(same(tr.params_best, tr2.params_best)
                       and same(tr.params_new, tr2.params_new)),
          same_ring=same(ring, ring2),
          same_generators=all(torch.equal(getattr(tr, g).get_state(),
                                          getattr(tr2, g).get_state())
                              for g in GENERATORS),
          same_counts=(tr.version, tr.outer_iter) == (tr2.version,
                                                      tr2.outer_iter),
          params_best=tr.params_best, ring_size=int(tr.buffer.size),
          ring_blocks=tr.buffer.capacity, gate_score=tr.last_gate_score,
          version=tr.version)
