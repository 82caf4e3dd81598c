"""The port's dense tower and the search's plain forward against JAX.

* ``DenseTower`` in float32 against the flax forward (width 64, 2 blocks):
  the same parameters through ``params_from_flax``; only summation order
  differs, tolerance 1e-5.
* ``dense_forward_reference`` (the plain version of the forward inside the
  chunk search) against the Pallas kernel's ``_dense_forward`` called
  directly on arrays under "highest" matmul precision: identical bf16
  operand rounding and float32 sums in another order.  Almost every output
  agrees to float32 rounding (median difference ~1e-8, measured); an
  activation whose float32 value lands within a rounding error of a bf16
  rounding boundary rounds to the neighbouring bf16 value in one engine and
  moves its outputs by up to ~2e-3 (measured at width 512).  Tolerance:
  95% of outputs within 1e-5, all within 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import ModelConfig
from alphazero_tpu.envs import make_env
from alphazero_tpu.models import build_model, init_params, make_eval_fn
from alphazero_tpu.search.pallas_fused import (_dense_forward, _game_tables,
                                               _pack_dense_params)
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.envs import make_env as make_tenv
from alphazero_tpu_torch.models import build_model as build_tmodel
from alphazero_tpu_torch.models import make_eval_fn as make_teval_fn
from alphazero_tpu_torch.models import params_from_flax
from alphazero_tpu_torch.search.fused import (dense_forward,
                                              dense_forward_reference,
                                              pack_dense_params)


def _obs(env, B, seed):
    rng = np.random.RandomState(seed)
    boards = (rng.rand(B, 2, env.rows, env.cols) < 0.25).astype(np.int8)
    boards[:, 1] *= 1 - boards[:, 0]
    players = rng.randint(0, 2, size=B).astype(np.int32)
    return np.array(jax.vmap(env.observation_from_board)(
        jnp.asarray(boards), jnp.asarray(players)), np.float32)


def _models(width, blocks, dtype="float32"):
    env, tenv = make_env("connect4"), make_tenv("connect4")
    model = build_model(ModelConfig(family="dense", width=width, blocks=blocks,
                                    compute_dtype=dtype), env)
    params = init_params(model, env, jax.random.PRNGKey(1))
    tmodel = build_tmodel(tcfg.ModelConfig(family="dense", width=width,
                                           blocks=blocks,
                                           compute_dtype=dtype), tenv)
    tparams = params_from_flax(jax.tree.map(np.asarray, params))
    return env, model, params, tmodel, tparams


def test_params_from_flax_loads_strictly():
    _, _, _, tmodel, tparams = _models(64, 2)
    tmodel.load_state_dict(tparams, strict=True)
    assert tparams["stem.weight"].shape == (64, 3 * 42 + 2 * 69)


def test_dense_tower_f32_matches_flax():
    env, model, params, tmodel, tparams = _models(64, 2)
    obs = _obs(env, 32, 0)
    want_logits, want_value = model.apply({"params": params}, obs,
                                          deterministic=True)
    tmodel.load_state_dict(tparams)
    with torch.no_grad():
        logits, value = tmodel(torch.as_tensor(obs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value),
                               atol=1e-5, rtol=1e-5)
    # the evaluator adapter: softmax over all actions, no legality mask
    want_p, want_v = make_eval_fn(model, params)(jnp.asarray(obs))
    with torch.no_grad():
        p, v = make_teval_fn(tmodel, tparams)(torch.as_tensor(obs))
    np.testing.assert_allclose(p.numpy(), np.asarray(want_p), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), atol=1e-5)


def test_dense_tower_bf16_close_to_flax():
    """bf16 compute rounds at other places in the two frameworks: held to
    bf16-class tolerance."""
    env, model, params, tmodel, tparams = _models(64, 2, "bfloat16")
    obs = _obs(env, 32, 1)
    want_logits, want_value = model.apply({"params": params}, obs,
                                          deterministic=True)
    with torch.no_grad():
        logits, value = torch.func.functional_call(
            tmodel, tparams, (torch.as_tensor(obs),))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits,
                                                          np.float32),
                               atol=0.05)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value,
                                                         np.float32),
                               atol=0.05)


@pytest.mark.parametrize("width,blocks", [(64, 2), (128, 1)])
def test_dense_forward_reference_matches_pallas_forward(width, blocks):
    env, model, params, tmodel, tparams = _models(width, blocks)
    B = 64
    obs = _obs(env, B, 2).reshape(B, -1)
    ws = _pack_dense_params(model, params)
    W = jnp.asarray(_game_tables(env)["W"])
    want_p, want_v = _dense_forward(env, model, ws, jnp.asarray(obs.T), W)
    packed = pack_dense_params(tmodel, tparams)
    p, v = dense_forward_reference(torch.as_tensor(obs), packed)
    for got, want in ((p.numpy(), np.asarray(want_p).T),
                      (v.numpy(), np.asarray(want_v)[0])):
        diff = np.abs(got - want)
        assert diff.max() <= 5e-3, diff.max()
        assert (diff <= 1e-5).mean() >= 0.95, np.sort(diff.ravel())[-10:]
    # the dispatching wrapper takes the plain version for CPU tensors
    p2, v2 = dense_forward(torch.as_tensor(obs), packed)
    assert torch.equal(p2, p) and torch.equal(v2, v)


# --- launch geometry of az_dense_forward (csrc/dense_forward.cu), on the
# CPU: the planner for every width the port and its tests use and every
# batch from 1 to 512 (self-play 512, the gate 128, eval 16, agent_move 1)

from alphazero_tpu_torch.search import fused  # noqa: E402

# clusters of 8 CTAs an H100 SXM holds at once at these shared-memory sizes
# (cudaOccupancyMaxActiveClusters on an H100 80GB HBM3: 15), and a card
# with more
H100_SLOTS = {16: 15, 32: 15, 48: 15}


@pytest.mark.parametrize("width", [64, 128, 192, 256, 320, 384, 448, 512])
@pytest.mark.parametrize("slots", [H100_SLOTS, {16: 40, 32: 40, 48: 40}])
def test_dense_plan_valid_for_every_batch(width, slots):
    """Every width a multiple of 64 up to 512, also where the cluster of
    width/64 CTAs does not divide the tile (3, 5, 6, 7 CTAs)."""
    kp, DV, A = 272, width // 4, 7           # connect4: 126 + 2·69 → 272
    for B in range(1, 513):
        pl = fused.dense_plan(B, width, kp, DV, A, slots)
        g, cs = pl["games_per_tile"], pl["cluster"]
        assert g in fused.DENSE_TILES and cs == width // 64 <= 8
        assert pl["tiles"] == -(-B // g) and pl["ctas"] == pl["tiles"] * cs
        assert pl["smem_bytes"] == fused.dense_smem_bytes(
            g, width, kp, DV, A) <= fused.SMEM_LIMIT
        # the smallest tile whose clusters fit in one wave, else the largest
        fits = [t for t in fused.dense_tiles(width, kp, DV, A)
                if -(-B // t) <= slots[t]]
        assert g == (fits[0] if fits else 48)
        assert pl["waves"] == -(-pl["tiles"] // slots[g])


def test_dense_plan_main_path_shapes():
    """connect4 at D=512: the gate's B=128 in 8 clusters of 16 games (64
    CTAs), self-play's B=512 in 11 clusters of 48 (one wave of the 15 the
    card holds); 16- and 32-game tiles keep a buffer for fc1's output."""
    p128 = fused.dense_plan(128, 512, 272, 128, 7, H100_SLOTS)
    p512 = fused.dense_plan(512, 512, 272, 128, 7, H100_SLOTS)
    assert (p128["games_per_tile"], p128["ctas"]) == (16, 64)
    assert (p512["games_per_tile"], p512["ctas"], p512["waves"]) == (48, 88, 1)
    assert fused.dense_smem_bytes(16, 512, 272, 128, 7) == 173_056
    assert fused.dense_smem_bytes(32, 512, 272, 128, 7) == 212_992
    assert fused.dense_smem_bytes(48, 512, 272, 128, 7) == 203_008


@pytest.mark.parametrize("width", [192, 320, 384, 448])
@pytest.mark.parametrize("games", fused.DENSE_TILES)
def test_dense_heads_slots_cover_a_tile_the_cluster_does_not_divide(width,
                                                                    games):
    """The heads' partial sums of game g go from rank q to slot [q][g // cs]
    of rank g mod cs, which finishes it (``csrc/dense_forward.cu``).  With
    ⌈games / cs⌉ slots per rank every (rank, game) pair has a slot of its
    own and every game is finished once."""
    cs = width // 64
    per = -(-games // cs)
    slots = {(g % cs, q * per + g // cs)
             for q in range(cs) for g in range(games)}
    assert len(slots) == cs * games
    assert all(slot < cs * per for _, slot in slots)
    finished = sorted(i * cs + r for r in range(cs) for i in range(per)
                      if i * cs + r < games)
    assert finished == list(range(games))


def test_dense_smem_counts_the_heads_slots_of_every_rank():
    """At D=192 (3 CTAs) a 16-game tile has 6 heads slots per rank: 3 × 6 ×
    (7 + 1) float32 = 576 bytes, not 16 × 8 × 4 = 512."""
    # two weight stages 2 × 64 × 280 bf16, input and fc1 rows 2 × 16 × 280
    # bf16, residual 16 × 72 float32, LayerNorm partials 3 × 16 × 2 float32,
    # value partials 8 × 16 float32, heads 576
    assert fused.dense_smem_bytes(16, 192, 272, 48, 7) == (
        2 * 35_840 + 2 * 8_960 + 4_608 + 384 + 512 + 576)


@pytest.mark.parametrize("D,kp,DV,A", [
    (96, 272, 24, 7),        # not a multiple of 64
    (1024, 272, 256, 7),     # a cluster of 16
    (512, 1600, 128, 225),   # gomoku15: 225 actions, a 1600-wide stem
    (512, 264, 128, 7),      # input width not padded to 16
    (128, 272, 20, 7)])      # value_fc slices not a multiple of 8
def test_dense_plan_refuses_widths_the_kernel_does_not_take(D, kp, DV, A):
    with pytest.raises(ValueError):
        fused.dense_plan(16, D, kp, DV, A, H100_SLOTS)
