"""The port's fused ResNet tower against the JAX package's.

The plain tower (``ops/resnet_tower.py:tower_reference``) plus the port's
float32 heads are held against the JAX ``make_fused_apply(interpret=True)``
(the Pallas ``_kernel`` in interpret mode), with the same flax parameters
through ``params_from_flax``.  Not against the eager ``ResNet`` forward: the
fused tower keeps its residual stream in float32.

Tolerance, on logits and value together: max ≤ 2e-2 and median ≤ 1e-5.
Both versions round the activations to bf16 at each conv's read and sum
exact products in float32, in another order; an activation within a
rounding error of a bf16 boundary may round the other way and move every
output of its game (4.9e-3 seen at 64×4), while the median stays at float32
rounding.

Also: ``supports_fused_resnet`` gives each preset the JAX package's
decision; ``make_eval_fn(fused_resnet=True)`` is the softmax of the fused
logits and the eager evaluator is unchanged without the opt-in;
``make_fused_apply`` raises for a tower the kernel does not take.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import ModelConfig
from alphazero_tpu.envs import make_env
from alphazero_tpu.models import build_model, init_params
from alphazero_tpu.ops.pallas_resnet import make_fused_apply
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.models import build_model as build_tmodel
from alphazero_tpu_torch.models import make_eval_fn, params_from_flax
from alphazero_tpu_torch.ops import resnet_tower as rt

TOL_MAX, TOL_MEDIAN = 2e-2, 1e-5


@functools.lru_cache(maxsize=None)
def _params(game, channels, blocks):
    """flax parameters with LayerNorm scales and biases moved off 1 and 0."""
    env = make_env(game)
    model = build_model(ModelConfig(family="resnet", channels=channels,
                                    blocks=blocks, compute_dtype="float32"),
                        env)
    params = init_params(model, env, jax.random.PRNGKey(0))
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(0)
    leaves = [x + 0.1 * rng.randn(*x.shape).astype(np.float32)
              for x in leaves]
    return model, jax.tree_util.tree_unflatten(tree, leaves)


def _obs(env, B, binary, seed):
    rng = np.random.RandomState(seed)
    obs = rng.rand(B, env.feature_dim, env.rows, env.cols).astype(np.float32)
    return (obs < 0.3).astype(np.float32) if binary else obs


def _assert_close(got, want):
    err = np.concatenate([np.abs(g.numpy() - np.asarray(w)).reshape(-1)
                          for g, w in zip(got, want)])
    assert err.max() <= TOL_MAX and np.median(err) <= TOL_MEDIAN, (
        err.max(), np.median(err))


@pytest.mark.parametrize("game,channels,blocks,B,binary", [
    ("connect4", 32, 2, 8, False),       # uniform observations
    ("tictactoe", 128, 3, 4, False),     # JAX's im2col path at C=128
    ("connect4", 64, 4, 16, True),       # the connect4-resnet tower, 0/1 obs
])
def test_plain_tower_and_heads_match_jax_fused(game, channels, blocks, B,
                                               binary):
    env = make_env(game)
    _, params = _params(game, channels, blocks)
    obs = _obs(env, B, binary, 1)
    want = make_fused_apply(env, channels, blocks, interpret=True)(
        params, jnp.asarray(obs))
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    got = rt.make_fused_apply(make_tenv(game), channels, blocks)(
        sd, torch.as_tensor(obs))
    _assert_close(got, want)


def test_geometry_from_the_model():
    """The ResNet module itself gives the geometry, as in the JAX test."""
    model, params = _params("tictactoe", 32, 2)
    obs = _obs(make_env("tictactoe"), 2, False, 3)
    want = make_fused_apply(model, 32, 2, interpret=True)(params,
                                                          jnp.asarray(obs))
    tmodel = build_tmodel(tcfg.ModelConfig(family="resnet", channels=32,
                                           blocks=2), make_tenv("tictactoe"))
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    got = rt.make_fused_apply(tmodel, 32, 2)(sd, torch.as_tensor(obs))
    _assert_close(got, want)


@pytest.mark.parametrize("name,fused", [("tictactoe", False),
                                        ("connect4-resnet", True),
                                        ("gomoku9", True),
                                        ("gomoku15", False)])
def test_supports_fused_resnet_per_preset(name, fused):
    """C=32 is too narrow; gomoku15's 13.3 MB of weights and 90.5 MB of
    aligned activations pass the 75 MB limit."""
    cfg = tcfg.preset(name)
    with torch.device("meta"):
        model = build_tmodel(cfg.model, make_tenv(cfg.env))
    assert rt.supports_fused_resnet(model) is fused


def _tmodel(channels, blocks):
    env = make_tenv("connect4")
    model = build_tmodel(tcfg.ModelConfig(family="resnet", channels=channels,
                                          blocks=blocks), env)
    _, params = _params("connect4", channels, blocks)
    return env, model, params_from_flax(jax.tree.map(np.asarray, params))


def test_make_eval_fn_fused_is_softmax_of_fused_logits():
    env, model, sd = _tmodel(64, 1)
    obs = torch.as_tensor(_obs(env, 3, True, 2))
    logits, value = rt.make_fused_apply(model, 64, 1)(sd, obs)
    p, v = make_eval_fn(model, sd, fused_resnet=True)(obs)
    assert torch.equal(p, torch.softmax(logits, -1)) and torch.equal(v, value)
    eager = make_eval_fn(model, sd)
    pe, ve = eager(obs)
    wl, wv = torch.func.functional_call(model, sd, (obs,))
    assert torch.equal(pe, torch.softmax(wl, -1)) and torch.equal(ve, wv)
    assert not torch.equal(pe, p)        # the two forwards round differently


def test_make_fused_apply_raises_for_a_tower_the_kernel_does_not_take():
    env = make_tenv("connect4")
    with pytest.raises(ValueError, match="channels"):
        rt.make_fused_apply(env, 192, 2)
    with pytest.raises(ValueError, match="shared memory"):
        rt.make_fused_apply(make_tenv("gomoku15"), 128, 2)


# --- launch geometry of az_resnet_tower (csrc/resnet_tower.cu), on the CPU:
# the planner's shapes for every batch the port gives the kernel

FUSED_TOWERS = [("connect4-resnet", 6 * 7, 64), ("gomoku9", 9 * 9, 128),
                ("tictactoe", 3 * 3, 32)]


def _fits(games, RC, C, rings=rt.RINGS):
    mt = 1 if rt.padded_rows(games, RC, 1) <= rt.WARPS * 16 else 2
    return (rt.padded_rows(games, RC, mt) <= rt.WARPS * 16 * mt
            and (mt == 1 or C <= 64)
            and any(rt.smem_bytes(games, RC, C, mt, s, t) <= rt.SMEM_LIMIT
                    for t, s in rings))


@pytest.mark.parametrize("sms", [132, 114])       # H100 SXM, H100 PCIe
@pytest.mark.parametrize("name,RC,C", FUSED_TOWERS)
def test_tower_plan_valid_for_every_batch(name, RC, C, sms):
    """B = 1..512 and the leaf-batched K·B: each CTA's shared memory within
    the 232,448 bytes, every game covered once, each warp at most one item
    of mt m-tiles; one wave of ≤ ``sms`` CTAs where some ring fits the
    games that takes, else the ring with the most taps per stage that fits
    a game."""
    for B in list(range(1, 513)) + [8 * 512]:
        pl = rt.plan(B, RC, C, sms)
        g, mt = pl["games"], pl["mt"]
        assert pl["smem_bytes"] == rt.smem_bytes(
            g, RC, C, mt, pl["stages"], pl["taps_per_stage"]) <= rt.SMEM_LIMIT
        assert pl["ctas"] == -(-B // g) and (pl["ctas"] - 1) * g < B
        assert mt in (1, 2) and (mt == 1 or C <= 64)
        assert rt.padded_rows(g, RC, mt) <= rt.WARPS * 16 * mt
        assert (pl["taps_per_stage"], pl["stages"]) in rt.RINGS
        one_wave = -(-B // sms)
        if _fits(one_wave, RC, C):
            assert g == one_wave and pl["ctas"] <= sms
        else:
            assert pl["ctas"] > sms
            taps = max(t for t, s in rt.RINGS if _fits(1, RC, C, [(t, s)]))
            assert pl["taps_per_stage"] == taps
            assert not _fits(g + 1, RC, C,
                             [r for r in rt.RINGS if r[0] == taps])


def test_tower_plan_main_path_shapes():
    """The shapes PERF.md reports: whole convs staged at connect4-resnet
    (4 games per CTA at B=512, 1 at the gate's 128, 4 again at the
    leaf-batched 8 × 512 in 1,024 CTAs, not 10 on single taps), single
    taps at gomoku9's 128 channels (2 games per CTA at B=256); 128 CTAs on
    an H100 SXM's 132 SMs."""
    assert rt.plan(512, 42, 64, 132) == {
        "games": 4, "mt": 1, "stages": 2, "taps_per_stage": 9,
        "smem_bytes": 226_800, "ctas": 128}
    assert rt.plan(128, 42, 64, 132)["games"] == 1
    assert rt.plan(128, 42, 64, 132)["taps_per_stage"] == 9
    assert rt.plan(4096, 42, 64, 132) == dict(rt.plan(512, 42, 64, 132),
                                              ctas=1024)
    g9 = rt.plan(256, 81, 128, 132)
    assert (g9["games"], g9["taps_per_stage"], g9["ctas"]) == (2, 1, 128)
    # a card of 114 SMs: one wave at B=512 takes 5 games per CTA, which fit
    # beside 3-tap stages only
    p114 = rt.plan(512, 42, 64, 114)
    assert (p114["games"], p114["taps_per_stage"], p114["ctas"]) == (5, 3, 103)


@pytest.mark.parametrize("rows,cols,F,C,match", [
    (6, 7, 3, 192, "channels"), (6, 7, 3, 24, "channels"),
    (6, 7, 17, 64, "input planes"), (15, 15, 2, 128, "shared memory")])
def test_tower_shapes_the_kernel_refuses(rows, cols, F, C, match):
    with pytest.raises(ValueError, match=match):
        rt.check_shape(rows, cols, F, C)
