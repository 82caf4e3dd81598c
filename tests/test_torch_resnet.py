"""The port's ResNet against the JAX package's flax ``ResNet``.

The same flax parameters go through ``params_from_flax`` into the torch
module; the inputs are canonical observations of random positions.
* float32: logits and value within 1e-5 (summation order only).
* bfloat16 compute (the presets' dtype): the two frameworks round
  activations to bf16 at the same places but sum in another order, so an
  activation within an ulp of a bf16 boundary may round the other way:
  every output within 5e-2 and the median error within 1e-2 (bf16 keeps
  8 significant bits: one ulp of a unit-size activation is 7.8e-3).
* ``make_eval_fn`` gives softmax probabilities and no ``dense_spec``.
* One learner step's loss, its parts and every gradient match ``jax.grad``
  of the JAX ``loss_fn`` within 1e-5 relative at float32.
* ``init_params`` draws flax's shapes and scales.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import ModelConfig
from alphazero_tpu.envs import make_env
from alphazero_tpu.models import build_model, init_params, make_eval_fn
from alphazero_tpu.training.learner import loss_fn
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.models import build_model as build_tmodel
from alphazero_tpu_torch.models import init_params as tinit
from alphazero_tpu_torch.models import make_eval_fn as make_teval_fn
from alphazero_tpu_torch.models import params_from_flax
from alphazero_tpu_torch.training import learner


def _obs(name, B, seed):
    env = make_tenv(name)
    rng = np.random.RandomState(seed)
    boards = (rng.rand(B, 2, env.rows, env.cols) < 0.3).astype(np.int8)
    boards[:, 1] *= 1 - boards[:, 0]
    players = rng.randint(0, 2, size=B).astype(np.int32)
    return env.observation_from_board(torch.as_tensor(boards),
                                      torch.as_tensor(players))


@functools.lru_cache(maxsize=None)
def _init(name, channels, blocks, seed):
    """flax ``init_params`` of one geometry (float32 parameters for any
    compute dtype), jitted and shared between tests."""
    env = make_env(name)
    model = build_model(ModelConfig(family="resnet", channels=channels,
                                    blocks=blocks), env)
    return jax.jit(lambda k: init_params(model, env, k))(
        jax.random.PRNGKey(seed))


def _pair(name, dtype, channels=8, blocks=2, seed=0):
    env = make_env(name)
    mc = dict(family="resnet", channels=channels, blocks=blocks,
              compute_dtype=dtype)
    model = build_model(ModelConfig(**mc), env)
    params = _init(name, channels, blocks, seed)
    # non-trivial LayerNorm scales and head biases
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(seed)
    leaves = [x + 0.1 * rng.randn(*x.shape).astype(np.float32)
              for x in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    tmodel = build_tmodel(tcfg.ModelConfig(**mc), make_tenv(name))
    tparams = params_from_flax(jax.tree.map(np.asarray, params))
    return model, params, tmodel, tparams


@pytest.mark.parametrize("name", ["connect4", "gomoku"])
def test_forward_float32_matches_flax(name):
    model, params, tmodel, tparams = _pair(name, "float32")
    obs = _obs(name, 6, 1)
    want = jax.jit(model.apply)({"params": params},
                                jnp.asarray(obs.numpy()))
    got = torch.func.functional_call(tmodel, tparams, (obs,))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=0)


def test_forward_bfloat16_close_to_flax():
    model, params, tmodel, tparams = _pair("connect4", "bfloat16")
    obs = _obs("connect4", 16, 2)
    want = jax.jit(model.apply)({"params": params},
                                jnp.asarray(obs.numpy()))
    got = torch.func.functional_call(tmodel, tparams, (obs,))
    err = np.concatenate([np.abs(a.detach().float().numpy()
                                 - np.asarray(b, np.float32)).reshape(-1)
                          for a, b in zip(got, want)])
    assert err.max() <= 5e-2 and np.median(err) <= 1e-2, (err.max(),
                                                           np.median(err))


def test_eval_fn_softmax_and_no_dense_spec():
    model, params, tmodel, tparams = _pair("tictactoe", "float32")
    obs = _obs("tictactoe", 4, 3)
    p, v = make_teval_fn(tmodel, tparams)(obs)
    wp, wv = jax.jit(make_eval_fn(model, params))(jnp.asarray(obs.numpy()))
    np.testing.assert_allclose(p.numpy(), np.asarray(wp), atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), atol=1e-5)
    assert not hasattr(make_teval_fn(tmodel, tparams), "dense_spec")


def test_loss_and_grads_match_jax():
    model, params, tmodel, tparams = _pair("connect4", "float32")
    obs = _obs("connect4", 16, 4)
    rng = np.random.RandomState(5)
    pol = rng.rand(16, 7).astype(np.float32)
    pol /= pol.sum(-1, keepdims=True)
    val = rng.uniform(-1, 1, 16).astype(np.float32)
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
        diff = float((tp[name].grad - g).abs().max())
        assert diff <= 1e-5 * float(g.abs().max()), (name, diff)


def test_init_params_shapes_and_scales():
    """The flax tree's shapes (``eval_shape``, nothing computed), zero
    biases, unit LayerNorm scales and truncated LeCun kernels: the standard
    deviation of each kernel within 20% of ``√(1/fan_in)``."""
    env = make_env("connect4")
    model = build_model(ModelConfig(family="resnet", channels=16, blocks=2),
                        env)
    shapes = jax.eval_shape(lambda k: init_params(model, env, k),
                            jax.random.PRNGKey(0))
    flax_p = params_from_flax(jax.tree.map(
        lambda x: np.zeros(x.shape, np.float32), shapes))
    tmodel = build_tmodel(tcfg.ModelConfig(family="resnet", channels=16,
                                           blocks=2), make_tenv("connect4"))
    got = tinit(tmodel, torch.Generator().manual_seed(0))
    assert set(got) == set(flax_p)
    for k, w in flax_p.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k.endswith("bias"):
            assert (g == 0).all(), k
        elif w.dim() == 1:
            assert (g == 1).all(), k
        elif g.numel() >= 256:
            ratio = float(g.std()) * math.sqrt(g.numel() // g.shape[0])
            assert 0.8 < ratio < 1.2, (k, ratio)
