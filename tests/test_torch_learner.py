"""The port's replay sampling and learner against the JAX package.

* ``gather_sample`` on the ``(g, r, s)`` indices the JAX ``sample`` draws
  (recomputed here from its key) equals the JAX sample bitwise: obs, policy
  and value, with connect4's left-right symmetry.
* ``sample_indices`` keeps the sampling semantics: games ∝ length, rows
  inside the game, identity before ``augment_skip``, the empty-buffer guard.
* One step's loss, its parts and every gradient match ``jax.grad`` of the
  JAX ``loss_fn`` from the same parameters and batch: within 1e-5 relative
  in float32 (summation order only), and within 2e-2 of the loss and 5e-2 of
  each gradient's largest entry in bfloat16 compute (the two frameworks
  round to bf16 at different places).
* On the same gradients (JAX's, converted), three steps of the port's
  optimizer match optax's Adam to 1e-6 absolute: updates are ~2.5e-4 per
  step and the two Adam formulas round differently, by a few ulps of the
  weight.
* Three whole training steps match optax per element to 2e-6 plus the
  gradient test's tolerance (1e-5 of each tensor's largest gradient entry)
  carried through Adam's step slope ``lr·eps/(|g|+eps)²``, summed over the
  steps.  A fixed tolerance does not hold: where a gradient nearly cancels
  (|g| ~ 6e-8 where the median is ~7e-3) the slope is ~480, so a
  summation-order difference of ~6e-9 in g moves the weight by ~3e-6.
* ``train_epoch`` runs exactly ``steps`` steps and reports the mean of the
  last chunk of ≤ 32 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alphazero_tpu.config import ModelConfig
from alphazero_tpu.data.augment import Symmetries
from alphazero_tpu.data.replay import ReplayBuffer, sample
from alphazero_tpu.envs import make_env
from alphazero_tpu.models import build_model, init_params
from alphazero_tpu.training.learner import loss_fn
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.data import ReplayBuffer as TReplayBuffer
from alphazero_tpu_torch.data import (Symmetries as TSymmetries, create,
                                      gather_sample, sample_indices)
from alphazero_tpu_torch.data import sample as tsample
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.models import build_model as build_tmodel
from alphazero_tpu_torch.models import params_from_flax
from alphazero_tpu_torch.training import learner

SKIP = 2


def _buffer_arrays(seed, G=12):
    rng = np.random.RandomState(seed)
    L, A = 42, 7
    length = rng.randint(1, L + 1, size=G).astype(np.int32)
    length[[3, 7]] = 0                                  # empty blocks
    obs = (rng.rand(G, L, 3, 6, 7) < 0.3).astype(np.int8)
    pol = rng.rand(G, L, A).astype(np.float32)
    pol /= pol.sum(-1, keepdims=True)
    winner = rng.randint(-1, 2, size=G).astype(np.int32)
    return obs, pol, length, winner


def _buffers(seed, G=12):
    obs, pol, length, winner = _buffer_arrays(seed, G)
    jbuf = ReplayBuffer(obs=jnp.asarray(obs), policy=jnp.asarray(pol),
                        length=jnp.asarray(length), winner=jnp.asarray(winner),
                        cursor=jnp.int32(0), size=jnp.int32(G))
    tbuf = TReplayBuffer(obs=torch.as_tensor(obs), policy=torch.as_tensor(pol),
                         length=torch.as_tensor(length),
                         winner=torch.as_tensor(winner),
                         cursor=torch.tensor(0, dtype=torch.int32),
                         size=torch.tensor(G, dtype=torch.int32))
    return jbuf, tbuf


def test_gather_sample_bitwise_vs_jax_sample():
    jbuf, tbuf = _buffers(0)
    env = make_env("connect4")
    syms = Symmetries(env)
    key, bs = jax.random.PRNGKey(4), 96
    want = [np.asarray(x) for x in sample(jbuf, key, bs, syms, SKIP)]
    # the indices the JAX sample drew (data/replay.py:205-225)
    kg, kr, ks = jax.random.split(key, 3)
    logits = jnp.where(jbuf.length > 0,
                       jnp.log(jnp.maximum(jbuf.length, 1).astype(jnp.float32)),
                       -jnp.inf)
    g = jax.random.categorical(kg, logits, shape=(bs,))
    r = jax.random.randint(kr, (bs,), 0, 1 << 30) \
        % jnp.maximum(jbuf.length[g], 1)
    s = jnp.where(r < SKIP, 0, jax.random.randint(ks, (bs,), 0, syms.num))
    idx = [torch.as_tensor(np.array(x)).long() for x in (g, r, s)]
    assert (idx[2] == 1).any() and (idx[1] < SKIP).any()
    got = gather_sample(tbuf, *idx,
                        TSymmetries(make_tenv("connect4"), device="cpu"))
    for name, a, b in zip(("obs", "policy", "value"), got, want):
        assert a.dtype == torch.float32, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_sample_indices_semantics():
    _, tbuf = _buffers(1)
    gen = torch.Generator().manual_seed(0)
    n = 40000
    g, r, s = sample_indices(tbuf, n, generator=gen, num_syms=2,
                             augment_skip=SKIP)
    length = tbuf.length.long()
    assert (length[g] > 0).all() and (r < length[g]).all() and (r >= 0).all()
    assert (s[r < SKIP] == 0).all() and set(s.tolist()) == {0, 1}
    freq = torch.bincount(g, minlength=length.numel()).double() / n
    np.testing.assert_allclose(freq.numpy(),
                               (length / length.sum()).double().numpy(),
                               atol=0.01)
    # an empty buffer samples block 0: zero observations, value 0
    empty = create(make_tenv("connect4"), 42 * 4, device="cpu")
    g, _, _ = sample_indices(empty, 8, generator=gen)
    obs, pol, val = tsample(empty, 8, generator=gen)
    assert (g == 0).all() and (val == 0).all() and (obs == 0).all()
    assert obs.shape == (8, 3, 6, 7)


def _models(dtype, width=64, blocks=2, seed=2):
    env, tenv = make_env("connect4"), make_tenv("connect4")
    model = build_model(ModelConfig(family="dense", width=width, blocks=blocks,
                                    compute_dtype=dtype), env)
    params = init_params(model, env, jax.random.PRNGKey(seed))
    tmodel = build_tmodel(tcfg.ModelConfig(family="dense", width=width,
                                           blocks=blocks,
                                           compute_dtype=dtype), tenv)
    return model, params, tmodel


def _batch(seed, bs=32):
    jbuf, tbuf = _buffers(seed)
    gen = torch.Generator().manual_seed(seed)
    syms = TSymmetries(make_tenv("connect4"), device="cpu")
    return tsample(tbuf, bs, generator=gen, syms=syms, augment_skip=SKIP)


def _tparams(params, grad=True):
    return {k: v.requires_grad_(grad)
            for k, v in params_from_flax(jax.tree.map(np.asarray,
                                                      params)).items()}


@pytest.mark.parametrize("dtype,tol_loss,tol_grad", [
    ("float32", 1e-5, 1e-5), ("bfloat16", 2e-2, 5e-2)])
def test_loss_and_grads_match_jax(dtype, tol_loss, tol_grad):
    model, params, tmodel = _models(dtype)
    obs, pol, val = _batch(3)
    l2c = 1e-4
    (_, want_m), want_g = jax.value_and_grad(
        lambda p: loss_fn(model, p, jnp.asarray(obs.numpy()),
                          jnp.asarray(pol.numpy()), jnp.asarray(val.numpy()),
                          l2c), has_aux=True)(params)
    tp = _tparams(params)
    loss, got_m = learner.loss_fn(tmodel, tp, obs, pol, val, l2c)
    loss.backward()
    for name in ("loss", "policy_loss", "value_loss", "l2"):
        a = float(getattr(got_m, name).detach())
        b = float(getattr(want_m, name))
        assert abs(a - b) <= tol_loss * abs(b), (name, a, b)
    want_g = params_from_flax(jax.tree.map(np.asarray, want_g))
    assert set(want_g) == set(tp)
    for name, g in want_g.items():
        scale = float(g.abs().max())
        diff = float((tp[name].grad - g).abs().max())
        assert diff <= tol_grad * scale, (name, diff, scale)


LR, EPS = 2.5e-4, 1e-8     # optax.adam's and torch.optim.Adam's eps


def _optax_steps(model, params, batch, l2c, steps=3):
    """``steps`` optax Adam steps on one batch: the final parameters and the
    gradient of each step, both as the port's ``state_dict``."""
    opt = optax.adam(LR)
    state = opt.init(params)
    jb = [jnp.asarray(x.numpy()) for x in batch]
    p, grads = params, []
    for _ in range(steps):
        g, _ = jax.grad(lambda q: loss_fn(model, q, *jb, l2c),
                        has_aux=True)(p)
        grads.append(params_from_flax(jax.tree.map(np.asarray, g)))
        upd, state = opt.update(g, state, p)
        p = optax.apply_updates(p, upd)
    return params_from_flax(jax.tree.map(np.asarray, p)), grads


def test_adam_matches_optax_on_the_same_gradients():
    """The optimizer alone: JAX's gradients fed to both Adams."""
    model, params, _ = _models("float32")
    want, grads = _optax_steps(model, params, _batch(5), 1e-4)
    tp = _tparams(params)
    topt = learner.make_optimizer(tcfg.TrainConfig(learning_rate=LR), tp)
    for g in grads:
        for name, t in tp.items():
            t.grad = g[name].clone()
        topt.step()
    for name, w in want.items():
        np.testing.assert_allclose(tp[name].detach().numpy(), w.numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)


def test_three_adam_steps_match_optax():
    """Three whole steps (loss, backward, Adam) against optax.  Per element
    the tolerance is 2e-6 plus, for each step k, the gradient test's bound
    on a gradient difference (1e-5 · max |g_k| of the tensor) times Adam's
    step slope ``lr·eps/(|g_k|+eps)²`` at that element's JAX gradient."""
    model, params, tmodel = _models("float32")
    obs, pol, val = _batch(5)
    l2c = 1e-4
    want, grads = _optax_steps(model, params, (obs, pol, val), l2c)
    tp = _tparams(params)
    topt = learner.make_optimizer(tcfg.TrainConfig(learning_rate=LR), tp)
    for _ in range(3):
        learner.train_step(tmodel, tp, topt, obs, pol, val, l2c)
    start = params_from_flax(jax.tree.map(np.asarray, params))
    for name, w in want.items():
        tol = torch.full_like(w, 2e-6, dtype=torch.float64)
        for g in grads:
            ga = g[name].abs().double()
            tol += LR * EPS / (ga + EPS) ** 2 * (1e-5 * float(ga.max()))
        diff = (tp[name].detach() - w).abs().double()
        bad = diff > tol
        assert not bad.any(), (name, int(bad.sum()), float(diff[bad].max()))
        assert not torch.equal(w, start[name]) or name.endswith("bias")


def test_train_epoch_runs_exact_steps_and_reports_last_chunk():
    _, params, tmodel = _models("float32", width=16, blocks=1)
    tp = _tparams(params, grad=False)
    before = {k: v.clone() for k, v in tp.items()}
    _, tbuf = _buffers(6)
    syms = TSymmetries(make_tenv("connect4"), device="cpu")
    cfg = tcfg.TrainConfig(batch_size=8)
    steps, chunk = 35, 32
    new, m = learner.train_epoch(tmodel, tp, tbuf, cfg, steps,
                                 generator=torch.Generator().manual_seed(1),
                                 syms=syms, augment_skip=SKIP,
                                 chunk_steps=chunk)
    assert all(torch.equal(tp[k], before[k]) for k in tp)   # input untouched
    # the same run step by step
    gen = torch.Generator().manual_seed(1)
    ps = {k: v.clone().requires_grad_(True) for k, v in before.items()}
    opt = learner.make_optimizer(cfg, ps)
    hist = []
    for _ in range(steps):
        batch = tsample(tbuf, 8, generator=gen, syms=syms, augment_skip=SKIP)
        hist.append(learner.train_step(tmodel, ps, opt, *batch, cfg.l2_coeff))
    assert opt.state[ps["stem.weight"]]["step"] == steps
    for k in ps:
        assert torch.equal(new[k], ps[k].detach()), k
    last = hist[chunk:]
    for name in learner.TrainMetrics._fields:
        want = torch.stack([getattr(h, name) for h in last]).mean()
        assert torch.equal(getattr(m, name), want), name
    assert float(m.loss) != float(torch.stack([h.loss for h in hist]).mean())
