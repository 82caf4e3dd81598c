"""The port's mesh layer against the JAX package's ``parallel/``, on CPU
ranks of a gloo group (``tests/test_torch_ranks.py``).

* ``to_sharded`` and ``create_sharded`` equal JAX's bit for bit, on a
  wrapped ring, a partly filled one and capacities that do not divide;
  ``shard_of`` and ``stack_shards`` invert each other; ``create_ring``
  is ``to_sharded``'s ring of an empty buffer.
* ``plan_ranks``: local ranks and the backend from every rank's host,
  device and card count (CPU ranks, ranks sharing a card, one host and
  two with a card a rank, hosts interleaved, a host short of cards).
* Data parallelism: two ranks with half a batch each, their gradients
  averaged, match the port's single-process gradients on the whole batch
  and ``jax.grad`` of the JAX ``loss_fn`` (``tests/test_parallel.py``'s
  rtol 2e-4 / atol 1e-5: the sum over ranks is another summation order);
  after one Adam step the two ranks' parameters are bitwise equal.
* Tensor parallelism, on four ranks (data=2, model=2, so the mesh's
  groups are checked too): the ViT split over two model ranks, in
  float32, gives the replicated port's and flax's forward within rtol /
  atol 1e-5 (``test_parallel.py``'s tolerance); one learner step's
  gradients without dropout (each data rank half the batch, each slice put
  back in place) are within 1e-5 of each parameter's largest replicated
  whole-batch gradient (``tests/test_torch_vit.py``'s tolerance; the key
  biases, true gradient 0, within 1e-7 of 0), and bitwise equal across
  the data ranks; with dropout on and the replicated model's generator
  state it draws the same masks, so its forward is within the same 1e-5;
  the reported ``l2`` and ``loss`` are the whole model's and the data
  group's mean (rtol 1e-6: another summation order).
* The command line: ``train --mesh data=2 --device cpu`` in one command
  (the ranks started by ``parallel.distributed.launch``) and as two
  processes joined at ``--coordinator``; rank 0 alone prints the metrics.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from alphazero_tpu.config import ModelConfig
from alphazero_tpu.data import add_games
from alphazero_tpu.data import create as jcreate
from alphazero_tpu.data import create_sharded as jcreate_sharded
from alphazero_tpu.data.replay import to_sharded as jto_sharded
from alphazero_tpu.envs import make_env
from alphazero_tpu.models import build_model, init_params
from alphazero_tpu.training.learner import loss_fn
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.data import (ReplayBuffer, create, create_sharded,
                                      shard_of, stack_shards, to_sharded)
from alphazero_tpu_torch.data.replay import create_ring
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.models import build_model as build_tmodel
from alphazero_tpu_torch.models import params_from_flax
from alphazero_tpu_torch.parallel.distributed import free_port, plan_ranks
from alphazero_tpu_torch.parallel.mesh import vit_split_dim
from alphazero_tpu_torch.training import learner
from tests import test_torch_ranks as torch_ranks
from tests.test_torch_resnet import _obs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("obs", "policy", "length", "winner", "cursor", "size")


def _filled(n_games, G=13):
    """A JAX flat ring of ``G`` tictactoe blocks after ``n_games`` games
    (block b's first cell holds its game number), and the port's copy."""
    env = make_env("tictactoe")
    L = env.max_moves
    buf = jcreate(env, G * L)
    obs = jnp.zeros((n_games, L, env.feature_dim, env.rows, env.cols),
                    jnp.int8)
    obs = obs.at[:, :, 0, 0, 0].set(
        (jnp.arange(n_games) % 100)[:, None].astype(jnp.int8))
    buf = add_games(buf, obs, jnp.ones((n_games, L, 9)) / 9,
                    jnp.arange(n_games, dtype=jnp.int32) % L + 1,
                    jnp.arange(n_games, dtype=jnp.int32) % 3 - 1,
                    jnp.ones((n_games,), bool))
    tbuf = ReplayBuffer(**{k: torch.as_tensor(np.asarray(getattr(buf, k)))
                           for k in FIELDS})
    return buf, tbuf


def _eq(jbuf, tbuf):
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jbuf, k)),
                                      getattr(tbuf, k).numpy(), err_msg=k)


@pytest.mark.parametrize("games,shards", [(5, 2), (13, 2), (30, 2), (7, 4),
                                          (40, 3)])
def test_to_sharded_matches_jax(games, shards):
    """Partly filled, exactly full and wrapped rings; 13 blocks split over
    2, 4 and 3 rings drop the blocks that do not divide."""
    jbuf, tbuf = _filled(games)
    _eq(jto_sharded(jbuf, shards), to_sharded(tbuf, shards))


def test_create_sharded_matches_jax_and_refuses_uneven_rings():
    env, tenv = make_env("connect4"), make_tenv("connect4")
    _eq(jcreate_sharded(env, 42 * 16, 4),
        create_sharded(tenv, 42 * 16, 4, device="cpu"))
    with pytest.raises(ValueError, match="do not divide"):
        create_sharded(tenv, 42 * 15, 2, device="cpu")
    # one rank's ring alone is to_sharded's ring of an empty flat buffer
    for G, n in ((16, 4), (15, 2)):
        ring = create_ring(tenv, 42 * G, n, device="cpu")
        want = shard_of(to_sharded(create(tenv, 42 * G, device="cpu"), n), 1)
        for k in FIELDS:
            assert torch.equal(getattr(ring, k), getattr(want, k)), (G, k)
    with pytest.raises(ValueError, match="cannot make"):
        create_ring(tenv, 42, 2, device="cpu")


# the facts every rank publishes, listed by rank: (host, device, cards)
PLANS = {
    "cpu ranks": ([("h", "cpu", 0)] * 2, [0, 1], "gloo"),
    "two ranks share one card": ([("h", "cuda", 1)] * 2, [0, 1], "gloo"),
    "one host, a card each": ([("h", "cuda", 4)] * 4, [0, 1, 2, 3], "nccl"),
    "two hosts x four cards": ([("a", "cuda", 4)] * 4 + [("b", "cuda", 4)] * 4,
                               [0, 1, 2, 3] * 2, "nccl"),
    "hosts interleaved by rank": ([("a", "cuda", 2), ("b", "cuda", 2)] * 2,
                                  [0, 0, 1, 1], "nccl"),
    "one host holds more ranks than cards": (
        [("a", "cuda", 4)] * 4 + [("b", "cuda", 2)] * 4, [0, 1, 2, 3] * 2,
        "gloo"),
}


@pytest.mark.parametrize("case", PLANS)
def test_plan_ranks_local_rank_and_backend(case):
    """Each rank's local rank and every rank's backend from the facts all
    ranks publish: NCCL only when no card holds two ranks."""
    facts, local, backend = PLANS[case]
    plans = [plan_ranks(facts, r) for r in range(len(facts))]
    assert [p[0] for p in plans] == local
    assert {p[1] for p in plans} == {backend}


def test_shard_of_and_stack_shards_invert_each_other():
    _, tbuf = _filled(30)
    sh = to_sharded(tbuf, 2)
    rings = [shard_of(sh, i) for i in range(2)]
    assert rings[0].cursor.dim() == 0 and rings[1].capacity == 6
    back = stack_shards(rings)
    for k in FIELDS:
        assert torch.equal(getattr(back, k), getattr(sh, k)), k
    empty = create(make_tenv("tictactoe"), 9 * 13, device="cpu")
    assert torch.equal(to_sharded(empty, 2).size, torch.zeros(2,
                                                              dtype=torch.int32))


# ------------------------------------------------------ data parallelism
@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    env = make_env("tictactoe")
    mc = dict(family="resnet", channels=8, blocks=1, compute_dtype="float32")
    model = build_model(ModelConfig(**mc), env)
    params = init_params(model, env, jax.random.PRNGKey(0))
    obs = jax.random.uniform(jax.random.PRNGKey(1),
                             (64, env.feature_dim, env.rows, env.cols))
    pol = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(2), (64, 9)))
    val = jax.random.uniform(jax.random.PRNGKey(3), (64,), minval=-1)
    l2c = 1e-4
    jgrads = jax.jit(jax.grad(
        lambda p: loss_fn(model, p, obs, pol, val, l2c)[0]))(params)
    spec = dict(env="tictactoe", model=mc, l2=l2c,
                params=params_from_flax(jax.tree.map(np.asarray, params)),
                obs=torch.as_tensor(np.asarray(obs)),
                pol=torch.as_tensor(np.asarray(pol)),
                val=torch.as_tensor(np.asarray(val)))
    ranks = torch_ranks.run(torch_ranks.dp_step, 2,
                            tmp_path_factory.mktemp("dp"), spec)
    return spec, params_from_flax(jax.tree.map(np.asarray, jgrads)), ranks


def _single_grads(spec):
    model = build_tmodel(tcfg.ModelConfig(**spec["model"]),
                         make_tenv(spec["env"]))
    ps = learner.leaf_copies(spec["params"])
    loss, _ = learner.loss_fn(model, ps, spec["obs"], spec["pol"],
                              spec["val"], spec["l2"])
    loss.backward()
    return {k: p.grad for k, p in ps.items()}


def test_data_parallel_gradients_match_single_process_and_jax(dp):
    spec, jgrads, ranks = dp
    single = _single_grads(spec)
    for r in ranks:
        for k, g in r["grads"].items():
            np.testing.assert_allclose(g.numpy(), single[k].numpy(),
                                       rtol=2e-4, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(g.numpy(), jgrads[k], rtol=2e-4,
                                       atol=1e-5, err_msg=k)


def test_data_parallel_step_leaves_ranks_bitwise_equal(dp):
    spec, _, (r0, r1) = dp
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
        assert torch.equal(r0["grads"][k], r1["grads"][k]), k
    assert all(not torch.equal(r0["params"][k], p)
               for k, p in spec["params"].items())
    assert all(torch.equal(a, b) for a, b in zip(r0["metrics"],
                                                 r1["metrics"]))


def test_data_parallel_loss_is_the_data_groups_mean(dp):
    spec, _, (r0, _) = dp
    model = build_tmodel(tcfg.ModelConfig(**spec["model"]),
                         make_tenv(spec["env"]))
    halves = [learner.loss_fn(model, spec["params"], spec["obs"][sl],
                              spec["pol"][sl], spec["val"][sl], spec["l2"])[1]
              for sl in (slice(0, 32), slice(32, 64))]
    for i, name in enumerate(("loss", "policy_loss", "value_loss", "l2")):
        want = (float(halves[0][i]) + float(halves[1][i])) / 2
        assert abs(float(r0["metrics"][i]) - want) <= 1e-6 * abs(want), name


# ---------------------------------------------------- tensor parallelism
VIT = dict(family="vit", embed_dim=32, patch_size=3, num_heads=4, depth=2,
           dropout=0.1, compute_dtype="float32")


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    env = make_env("tictactoe")
    model = build_model(ModelConfig(**{**VIT, "dropout": 0.0}), env)
    params = init_params(model, env, jax.random.PRNGKey(0))
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_unflatten(
        tree, [x + 0.1 * rng.randn(*x.shape).astype(np.float32)
               for x in leaves])
    obs = _obs("tictactoe", 16, 4)
    want = [np.asarray(a) for a in jax.jit(model.apply)(
        {"params": params}, jnp.asarray(obs.numpy()), deterministic=True)]
    pol = rng.rand(16, 9).astype(np.float32)
    pol /= pol.sum(-1, keepdims=True)
    spec = dict(env="tictactoe", model=VIT, l2=1e-4, seed=7, obs=obs,
                params=params_from_flax(jax.tree.map(np.asarray, params)),
                pol=torch.as_tensor(pol),
                val=torch.as_tensor(rng.uniform(-1, 1, 16).astype(
                    np.float32)))
    ranks = torch_ranks.run(torch_ranks.tp_vit, 4,
                            tmp_path_factory.mktemp("tp"), spec)
    tmodel = build_tmodel(tcfg.ModelConfig(**VIT), make_tenv("tictactoe"))
    return spec, want, tmodel, ranks


def _gathered(ranks, key):
    """The model ranks' slices of data index 0, put together."""
    ranks = [r for r in ranks if r["index"][0] == 0]
    out = {}
    for k, v in ranks[0][key].items():
        dim = vit_split_dim(k)
        out[k] = v if dim is None else torch.cat([r[key][k] for r in ranks],
                                                 dim)
    return out


def test_mesh_places_ranks_row_major(tp):
    assert [r["index"] for r in tp[3]] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_tp_vit_forward_matches_replicated_and_flax(tp):
    spec, want, tmodel, ranks = tp
    rep = functional_call(tmodel, spec["params"], (spec["obs"],))
    for r in ranks:
        for got, w, f in zip((r["logits"], r["value"]), rep, want):
            np.testing.assert_allclose(got.numpy(), w.detach().numpy(),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got.numpy(), f, rtol=1e-5, atol=1e-5)


def test_tp_vit_gradients_match_replicated(tp):
    spec, _, tmodel, ranks = tp
    ps = learner.leaf_copies(spec["params"])
    loss, _ = learner.loss_fn(tmodel, ps, spec["obs"], spec["pol"],
                              spec["val"], spec["l2"])
    loss.backward()
    got = _gathered(ranks, "grads")
    assert set(got) == set(ps)
    for k, p in ps.items():
        g = p.grad
        if k.endswith("attn.key.bias"):     # the softmax ignores the shift
            assert max(float(got[k].abs().max()), float(g.abs().max())) \
                <= 1e-7
            continue
        diff = float((got[k] - g).abs().max())
        assert diff <= 1e-5 * float(g.abs().max()), (k, diff)
        if vit_split_dim(k) is None:       # replicated: the same on each
            assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k]), k
    for a, b in zip(ranks[:2], ranks[2:]):     # the data group's mean
        assert all(torch.equal(a["grads"][k], b["grads"][k])
                   for k in a["grads"])


def test_tp_vit_dropout_draws_the_replicated_masks(tp):
    spec, _, tmodel, ranks = tp
    gen = torch.Generator().manual_seed(spec["seed"])
    rep = functional_call(tmodel, spec["params"], (spec["obs"],),
                          {"dropout_generator": gen})
    plain = functional_call(tmodel, spec["params"], (spec["obs"],))
    assert not torch.allclose(rep[0], plain[0], atol=1e-3)
    for r in ranks:
        for got, w in zip(r["drop"], rep):
            np.testing.assert_allclose(got.numpy(), w.detach().numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_tp_vit_reports_the_whole_models_l2(tp):
    spec, _, tmodel, ranks = tp
    halves = [learner.loss_fn(tmodel, spec["params"], spec["obs"][sl],
                              spec["pol"][sl], spec["val"][sl], spec["l2"])[1]
              for sl in (slice(0, 8), slice(8, 16))]
    for r in ranks:
        for name in ("l2", "loss"):
            a = float(getattr(r["metrics"], name))
            b = sum(float(getattr(h, name)) for h in halves) / 2
            assert abs(a - b) <= 1e-6 * abs(b), (name, a, b)


# ----------------------------------------------------------- the CLI
TINY = ["--preset", "tictactoe", "--iterations", "1", "--games-per-iter",
        "4", "--selfplay-batch", "16", "--sims", "8", "--batch-size", "32",
        "--capacity", "1024", "--gate-games", "8", "--device", "cpu"]


def _kinds(stdout):
    return [json.loads(ln)["kind"] for ln in stdout.splitlines()
            if ln.startswith("{")]


def _train(*flags, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "alphazero_tpu_torch", "train", *TINY,
         *flags], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, **kw)


def test_cli_train_mesh_one_command(tmp_path):
    proc = _train("--mesh", "data=2", "--workdir", str(tmp_path))
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err
    assert _kinds(out) == ["collect", "train", "gate", "iteration"], out
    assert err.count("backend gloo") == 2 and "mesh: {'data': 2" in err
    it = json.loads(out.splitlines()[-1])
    assert it["games"] >= 4 and np.isfinite(it["loss"]) and it["trained"]
    logged = _kinds(open(tmp_path / "metrics.jsonl").read())
    assert logged == ["collect", "train", "gate", "iteration"]
    assert os.path.exists(tmp_path / "config.json")


def test_cli_train_mesh_two_processes_at_a_coordinator(tmp_path):
    coord = f"127.0.0.1:{free_port()}"
    procs = [_train("--mesh", "data=2", "--coordinator", coord,
                    "--num-processes", "2", "--process-id", str(i))
             for i in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert _kinds(outs[0][0]) == ["collect", "train", "gate", "iteration"]
    assert _kinds(outs[1][0]) == []
