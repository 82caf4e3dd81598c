"""The port's ViT against the JAX package's flax ``ViT``.

The same flax parameters go through ``params_from_flax`` into the torch
module; the inputs are canonical observations of random positions.
* float32: logits and value within rtol 1e-4, atol 1e-5 (the JAX
  package's own ViT tolerance), on tictactoe and connect4 (patch 3) and
  gomoku 7×7 (patch 5).  Only a comparison of values catches a transposed
  token order or a wrong padding of the patch embedding.
* bfloat16 compute (the presets' dtype): the two frameworks round at the
  same places but sum in another order.  Every output within 5e-2, the
  median within 1e-2, and the largest difference at most twice flax's own
  bf16 rounding (its distance from the float32 forward).  Measured: up to
  3.5e-2 / median 7.4e-3 on these weights, the same size as either
  framework's bf16 forward from its float32 one.
* ``make_eval_fn`` gives softmax probabilities and no ``dense_spec``.
* ``init_params``: flax's shapes; LeCun kernels; ``cls_token`` and
  ``pos_embed`` from an untruncated normal(1.0) (std ≈ 1, values past 2σ).
* One learner step's loss, its parts and every gradient against
  ``jax.grad`` of the JAX ``loss_fn`` with dropout off, at float32: loss
  parts within 1e-5 relative, each gradient within 1e-5 of its largest
  element (measured: 1.7e-6), the attention's key biases, whose gradient
  is 0, within 1e-7 of 0 on both sides.  Masks from two RNGs cannot
  match, so dropout is tested on its own: two generators give two losses,
  one seed the same loss twice, no generator the deterministic forward;
  the dense tower and the ResNet
  ignore the generator; the attention mask is one (T, T) draw shared by
  every game and head; the keep rate is 0.9.
* ``expand_vit_depth`` against ``alphazero_tpu.models.surgery`` on the same
  flax parameters: the embedding, block 0, the final norm and the heads
  copied exactly, block 1 new and initialised as flax initialises it, and
  the deeper forward equal to flax's on the merged tree.
* One move's search at gomoku 7×7, ``formula="reference"``, with a float32
  ViT: JAX's ``run_mcts`` (its XLA engine on the CPU) and the port's
  ``run_mcts`` (the per-simulation engine) from the same parameters and
  root noise give the same visit counts and policy in every game, root Q
  within 1e-6.  A game could differ only where two PUCT scores lie within
  the forward's float32 error (≈ 1e-6) of each other; none did in 48
  games of 8 weight seeds.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig, ModelConfig
from alphazero_tpu.envs import make_env
from alphazero_tpu.models import build_model, init_params, make_eval_fn
from alphazero_tpu.models.surgery import expand_vit_depth
from alphazero_tpu.search.mcts import run_mcts
from alphazero_tpu.training.learner import loss_fn
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.models import build_model as build_tmodel
from alphazero_tpu_torch.models import init_params as tinit
from alphazero_tpu_torch.models import make_eval_fn as make_teval_fn
from alphazero_tpu_torch.models import params_from_flax
from alphazero_tpu_torch.models import surgery
from alphazero_tpu_torch.models.vit import _dropout
from alphazero_tpu_torch.search.mcts import run_mcts as trun_mcts
from alphazero_tpu_torch.training import learner
from tests.test_torch_resnet import _obs
from tests.test_torch_xla import _roots

PATCH = {"tictactoe": 3, "connect4": 3, "gomoku": 5}


def _mc(name, dtype, depth=2, embed=32):
    return dict(family="vit", embed_dim=embed, patch_size=PATCH[name],
                num_heads=4, depth=depth, dropout=0.1, compute_dtype=dtype)


@functools.lru_cache(maxsize=None)
def _init(name, depth, embed, seed):
    """flax ``init_params`` of one geometry (float32 parameters for any
    compute dtype), jitted and shared between tests."""
    env = make_env(name)
    model = build_model(ModelConfig(**_mc(name, "float32", depth, embed)),
                        env)
    return jax.jit(lambda k: init_params(model, env, k))(
        jax.random.PRNGKey(seed))


def _pair(name, dtype, depth=2, embed=32, seed=0, perturb=True):
    """flax model and parameters, the port's model and the same parameters
    (LayerNorm scales and biases made non-trivial with ``perturb``)."""
    env = make_env(name)
    model = build_model(ModelConfig(**_mc(name, dtype, depth, embed)), env)
    params = _init(name, depth, embed, seed)
    if perturb:
        leaves, tree = jax.tree_util.tree_flatten(params)
        rng = np.random.RandomState(seed)
        leaves = [x + 0.1 * rng.randn(*x.shape).astype(np.float32)
                  for x in leaves]
        params = jax.tree_util.tree_unflatten(tree, leaves)
    tmodel = build_tmodel(tcfg.ModelConfig(**_mc(name, dtype, depth, embed)),
                          make_tenv(name))
    tparams = params_from_flax(jax.tree.map(np.asarray, params))
    return model, params, tmodel, tparams


def _both(model, params, tmodel, tparams, obs):
    want = jax.jit(model.apply)({"params": params}, jnp.asarray(obs.numpy()))
    got = torch.func.functional_call(tmodel, tparams, (obs,))
    return ([a.detach().float().numpy() for a in got],
            [np.asarray(b, np.float32) for b in want])


@pytest.mark.parametrize("name", ["tictactoe", "connect4", "gomoku"])
def test_forward_float32_matches_flax(name):
    pair = _pair(name, "float32")
    assert set(pair[3]) == set(dict(pair[2].named_parameters()))
    got, want = _both(*pair, _obs(name, 6, 1))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["connect4", "gomoku"])
def test_forward_bfloat16_close_to_flax(name):
    obs = _obs(name, 16, 2)
    got, want = _both(*_pair(name, "bfloat16"), obs)
    _, want32 = _both(*_pair(name, "float32"), obs)
    err = np.concatenate([np.abs(a - b).reshape(-1)
                          for a, b in zip(got, want)])
    own = np.concatenate([np.abs(a - b).reshape(-1)
                          for a, b in zip(want, want32)])
    assert err.max() <= 5e-2 and np.median(err) <= 1e-2, (err.max(),
                                                           np.median(err))
    assert err.max() <= 2 * own.max(), (err.max(), own.max())


def test_eval_fn_softmax_and_no_dense_spec():
    model, params, tmodel, tparams = _pair("gomoku", "float32")
    obs = _obs("gomoku", 4, 3)
    fn = make_teval_fn(tmodel, tparams)
    p, v = fn(obs)
    wp, wv = jax.jit(make_eval_fn(model, params))(jnp.asarray(obs.numpy()))
    np.testing.assert_allclose(p.numpy(), np.asarray(wp), atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), atol=1e-5)
    assert not hasattr(fn, "dense_spec")


def test_init_params_shapes_and_scales():
    """The flax tree's shapes (``eval_shape``), zero biases, unit LayerNorm
    scales, LeCun kernels (std within 20% of ``√(1/fan_in)``, truncated at
    2σ), and the embeddings' untruncated normal(1.0)."""
    env = make_env("gomoku")
    model = build_model(ModelConfig(**_mc("gomoku", "float32", 1, 64)), env)
    shapes = jax.eval_shape(lambda k: init_params(model, env, k),
                            jax.random.PRNGKey(0))
    flax_p = params_from_flax(jax.tree.map(
        lambda x: np.zeros(x.shape, np.float32), shapes))
    tmodel = build_tmodel(tcfg.ModelConfig(**_mc("gomoku", "float32", 1, 64)),
                          make_tenv("gomoku"))
    got = tinit(tmodel, torch.Generator().manual_seed(0))
    assert set(got) == set(flax_p)
    for k, w in flax_p.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k in ("cls_token", "pos_embed"):
            continue
        if k.endswith("bias"):
            assert (g == 0).all(), k
        elif w.dim() == 1:
            assert (g == 1).all(), k
        else:
            fan_in = g.numel() // g.shape[0]
            ratio = float(g.std()) * math.sqrt(fan_in)
            assert 0.8 < ratio < 1.2, (k, ratio)
            assert float(g.abs().max()) * math.sqrt(fan_in) <= 2.0 / 0.8796
    pos = got["pos_embed"]                           # 50 × 64 draws
    assert 0.95 < float(pos.std()) < 1.05 and abs(float(pos.mean())) < 0.05
    assert float((pos.abs() > 2.0).float().mean()) > 0.03     # 4.6% if normal
    assert got["cls_token"].shape == (1, 1, 64)


def _targets(B, A, seed):
    rng = np.random.RandomState(seed)
    pol = rng.rand(B, A).astype(np.float32)
    pol /= pol.sum(-1, keepdims=True)
    return pol, rng.uniform(-1, 1, B).astype(np.float32)


def test_loss_and_grads_match_jax_without_dropout():
    model, params, tmodel, tparams = _pair("gomoku", "float32")
    obs = _obs("gomoku", 16, 4)
    pol, val = _targets(16, 49, 5)
    l2c = 1e-4
    (_, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(model, p, jnp.asarray(obs.numpy()),
                          jnp.asarray(pol), jnp.asarray(val), l2c),
        has_aux=True))(params)
    tp = {k: v.requires_grad_(True) for k, v in tparams.items()}
    loss, got_m = learner.loss_fn(tmodel, tp, obs, torch.as_tensor(pol),
                                  torch.as_tensor(val), l2c)
    loss.backward()
    for name in ("loss", "policy_loss", "value_loss", "l2"):
        a, b = float(getattr(got_m, name).detach()), float(getattr(want_m,
                                                                   name))
        assert abs(a - b) <= 1e-5 * abs(b), (name, a, b)
    want_g = params_from_flax(jax.tree.map(np.asarray, want_g))
    assert set(want_g) == set(tp)
    for name, g in want_g.items():
        got_g = tp[name].grad
        if name.endswith("attn.key.bias"):    # the softmax ignores a shift
            # common to every key: both gradients are 0 up to rounding
            assert max(float(got_g.abs().max()), float(g.abs().max())) <= 1e-7
            continue
        diff = float((got_g - g).abs().max())
        assert diff <= 1e-5 * float(g.abs().max()), (name, diff)


def _loss(model, params, obs, pol, val, gen):
    return float(learner.loss_fn(model, params, obs, torch.as_tensor(pol),
                                 torch.as_tensor(val), 1e-4, gen)[0])


def test_dropout_draws_from_its_generator():
    _, _, tmodel, tparams = _pair("gomoku", "float32")
    obs = _obs("gomoku", 8, 6)
    pol, val = _targets(8, 49, 7)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    a, a2, b = (_loss(tmodel, tparams, obs, pol, val, gen(s))
                for s in (1, 1, 2))
    off = _loss(tmodel, tparams, obs, pol, val, None)
    assert a == a2 and a != b and off not in (a, b)
    # no generator: the forward of make_eval_fn, deterministic
    logits, value = torch.func.functional_call(tmodel, tparams, (obs,))
    p, v = make_teval_fn(tmodel, tparams)(obs)
    torch.testing.assert_close(torch.softmax(logits, -1), p, rtol=0, atol=0)
    torch.testing.assert_close(value, v, rtol=0, atol=0)


@pytest.mark.parametrize("family", ["dense", "resnet"])
def test_families_without_dropout_ignore_the_generator(family):
    env = make_tenv("connect4")
    model = build_tmodel(tcfg.ModelConfig(family=family, width=64, blocks=1,
                                          channels=8,
                                          compute_dtype="float32"), env)
    params = tinit(model, torch.Generator().manual_seed(0))
    obs = _obs("connect4", 8, 8)
    pol, val = _targets(8, 7, 9)
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    assert (_loss(model, params, obs, pol, val, g)
            == _loss(model, params, obs, pol, val, None))
    assert torch.equal(g.get_state(), state)


def test_attention_dropout_mask_is_shared_by_games_and_heads():
    """The block's attention, run with a generator, equals the same
    attention computed by hand with ONE (T, T) mask of ``torch.rand`` from
    the same seed applied to every game and head; the generator then
    stands exactly T·T draws on."""
    _, _, tmodel, tparams = _pair("tictactoe", "float32", depth=1)
    tmodel.load_state_dict(tparams)
    attn = tmodel.block_0.attn
    B, T, E, H = 3, 10, 32, 4
    x = torch.randn(B, T, E, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(5)
    got = attn(x, torch.float32, g)
    after = torch.rand(4, generator=g)

    ref = torch.Generator().manual_seed(5)
    keep = torch.rand((T, T), generator=ref) < 0.9
    assert torch.equal(after, torch.rand(4, generator=ref))
    q, k, v = (getattr(attn, n)(x).reshape(B, T, H, E // H)
               for n in ("query", "key", "value"))
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk",
                                   q / math.sqrt(E // H), k), -1)
    w = w * keep / torch.tensor(0.9)
    want = attn.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, E))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert 0 < int((~keep).sum()) < T * T


def test_dropout_keep_rate_and_scale():
    """Elementwise dropout keeps 1 − rate of its inputs (400,000 draws:
    0.9 within 7 standard errors of 4.7e-4) and divides them by the keep
    rate in the input's dtype, as flax does."""
    g = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        y = _dropout(torch.ones(400_000, dtype=dtype), 0.1, g)
        kept = y != 0
        assert abs(float(kept.float().mean()) - 0.9) < 7 * 4.7e-4
        scale = torch.ones((), dtype=dtype) / torch.tensor(0.9, dtype=dtype)
        assert bool((y[kept] == scale).all())
    x = torch.randn(5)
    assert _dropout(x, 0.1, None) is x


def test_expand_vit_depth_matches_jax_surgery():
    env, tenv = make_env("gomoku"), make_tenv("gomoku")
    mc = _mc("gomoku", "float32", depth=1)
    params = _init("gomoku", 1, 32, 0)
    new_cfg, new_model, merged = expand_vit_depth(
        ModelConfig(**mc), env, params, 2, jax.random.PRNGKey(9))
    want = params_from_flax(jax.tree.map(np.asarray, merged))
    old = params_from_flax(jax.tree.map(np.asarray, params))

    tcfg_ = tcfg.ModelConfig(**mc)
    t_cfg, t_model, t_params = surgery.expand_vit_depth(
        tcfg_, tenv, old, 2, torch.Generator().manual_seed(9))
    assert (new_cfg.depth, t_cfg.depth, t_model.depth) == (2, 2, 2)
    assert dataclasses.replace(t_cfg, depth=1) == tcfg_
    assert set(t_params) == set(want)
    assert set(t_params) == set(dict(t_model.named_parameters()))
    for k, w in want.items():
        assert t_params[k].shape == w.shape, k
        if k in old:                          # copied, exactly as JAX does
            assert torch.equal(t_params[k], old[k]) and torch.equal(w, old[k])
        elif k.endswith("bias"):              # block 1: fresh init
            assert (t_params[k] == 0).all(), k
        elif t_params[k].dim() == 1:
            assert (t_params[k] == 1).all(), k
    assert any(k.startswith("block_1.") for k in set(want) - set(old))
    # the deeper forward of JAX's merged tree, through the port's model
    obs = _obs("gomoku", 4, 10)
    flax_model = build_model(ModelConfig(**dict(mc, depth=2)), env)
    got, ref = _both(flax_model, merged, t_model, want, obs)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    logits, value = torch.func.functional_call(t_model, t_params, (obs,))
    assert bool(torch.isfinite(logits).all() and torch.isfinite(value).all())
    with pytest.raises(ValueError):
        surgery.expand_vit_depth(t_cfg, tenv, t_params, 1,
                                 torch.Generator().manual_seed(0))


def test_gomoku7_reference_search_matches_jax():
    name, B, S = "gomoku", 6, 24
    model, params, tmodel, tparams = _pair(name, "float32", depth=1,
                                           perturb=False, seed=3)
    env = make_env(name)
    roots = _roots(name, B, 3)
    cfg = MCTSConfig(num_simulations=S, formula="reference",
                     dirichlet_alpha=0.3)
    key = jax.random.PRNGKey(11)
    want = run_mcts(env, make_eval_fn(model, params),
                    *(jnp.asarray(a) for a in roots), key, cfg)
    noise = np.array(jax.random.dirichlet(
        jax.random.split(key, 3)[1],
        jnp.full((env.action_dim,), 0.3, jnp.float32), shape=(B,)))
    got = trun_mcts(make_tenv(name), make_teval_fn(tmodel, tparams),
                    *(torch.as_tensor(a) for a in roots),
                    tcfg.MCTSConfig(num_simulations=S, formula="reference",
                                    dirichlet_alpha=0.3),
                    noise=torch.as_tensor(noise), device="cpu")
    np.testing.assert_array_equal(got.visit_counts.numpy(),
                                  np.asarray(want.visit_counts))
    np.testing.assert_array_equal(got.policy.numpy(),
                                  np.asarray(want.policy))
    np.testing.assert_allclose(got.root_q.numpy(), np.asarray(want.root_q),
                               rtol=0, atol=1e-6)
    assert (got.visit_counts.sum(-1) == S - 1).all()
