"""AlphaZero's batch-norm tower (``models.resnet.ResNetBN``) against the
benchmark's plain float32 reference (``azbench/reference/families/
resnet_bn.py``) on the CPU: seeded random weights at 16 × 2 on gomoku9,
B=8, the state calibrated by the reference on those positions.

* The float32 forward (batch norm folded into each convolution) matches
  the reference's within 1e-5 on logits and value, with the running
  statistics at 0 and 1 and with calibrated ones, so the state is read.
* The bf16 forward matches within 5e-2: its convolutions round both
  operands and every activation to bf16 (8 bits of mantissa, a relative
  step of 2⁻⁸ ≈ 4e-3), through 5 convolutions and their residual sums.
* Two mutants fail the float32 check: batch norm as the identity, and ε
  1e-3 in place of 1e-5.
* ``make_eval_fn``'s evaluator returns the model's softmax and value.
* ``init_params`` gives the family's names and shapes (the reference's,
  with the state beside them) and batch norm's initial values; the fused
  tower kernel refuses the family.
"""

import re

import pytest
import torch
from torch.func import functional_call

from alphazero_tpu_torch.config import ModelConfig
from alphazero_tpu_torch.envs import make_env
from alphazero_tpu_torch.models import (ResNetBN, build_model, init_params,
                                        make_eval_fn, resnet)
from alphazero_tpu_torch.ops.resnet_tower import supports_fused_resnet
from azbench import harness
from azbench.reference import games, nets

SPEC = {"family": "resnet_bn", "channels": 16, "blocks": 2}
ENV = "gomoku9"
B = 8


def _model(dtype="float32"):
    return build_model(ModelConfig(family="resnet_bn", channels=16, blocks=2,
                                   compute_dtype=dtype), make_env(ENV))


def _setup(state="calibrated", dtype="float32"):
    """The model, its seeded parameters with the state, and B positions."""
    model = _model(dtype)
    params = init_params(model, torch.Generator().manual_seed(0))
    g = games.game(ENV)
    obs = harness.random_positions(g, B, torch.Generator().manual_seed(1),
                                   torch.device("cpu"))
    if state == "calibrated":
        params.update(nets.Net(SPEC, g, params).state(obs))
    return model, params, obs


def _reference(params, obs):
    """The reference's ``(logits, value)`` in float32, TF32 off."""
    net = nets.Net(SPEC, games.game(ENV), params)
    with torch.no_grad(), nets.ieee_float32():
        return net.forward(net, obs)


def _port(model, params, obs):
    with torch.no_grad():
        return functional_call(model, params, (obs,))


def _gap(model, params, obs) -> float:
    got, want = _port(model, params, obs), _reference(params, obs)
    return max(float((a.float() - b).abs().max()) for a, b in zip(got, want))


@pytest.mark.parametrize("state", ["unit", "calibrated"])
def test_float32_forward_matches_the_reference(state):
    model, params, obs = _setup(state)
    if state == "calibrated":
        assert not torch.equal(params["block_1.bn2.running_var"],
                               torch.ones(16))
    assert _gap(model, params, obs) <= 1e-5


def test_bf16_forward_close_to_the_reference():
    model, params, obs = _setup(dtype="bfloat16")
    assert _gap(model, params, obs) <= 5e-2


def test_the_state_is_read():
    """Calibrated statistics move the outputs far beyond the tolerance."""
    model, params, obs = _setup()
    unit = {k: (torch.ones_like(v) if k.endswith("running_var") else
                torch.zeros_like(v) if k.endswith("running_mean") else v)
            for k, v in params.items()}
    got = _port(model, unit, obs)[0]
    want = _reference(params, obs)[0]
    assert float((got - want).abs().max()) > 1e-2


def test_batch_norm_as_identity_fails(monkeypatch):
    model, params, obs = _setup()

    def conv_only(x, conv, bn, dtype, train):
        return resnet._conv(x, conv, dtype)

    monkeypatch.setattr(resnet, "_conv_bn", conv_only)
    assert _gap(model, params, obs) > 1e-2


def test_another_epsilon_fails(monkeypatch):
    model, params, obs = _setup()
    monkeypatch.setattr(resnet, "BN_EPS", 1e-3)
    assert _gap(model, params, obs) > 1e-5


def test_eval_fn_is_the_model():
    model, params, obs = _setup()
    probs, value = make_eval_fn(model, params)(obs)
    logits, want_v = _port(model, params, obs)
    assert torch.equal(probs, torch.softmax(logits, -1))
    assert torch.equal(value, want_v)
    assert not hasattr(make_eval_fn(model, params), "dense_spec")


def _bn_layers(names) -> list:
    return sorted({n.rsplit(".", 1)[0] for n in names
                   if re.search(r"(^|[._])bn\d?\.weight$", n)})


def test_init_params_names_shapes_and_values():
    model = _model()
    params = init_params(model, torch.Generator().manual_seed(0))
    specs = nets.param_specs(SPEC, games.game(ENV))
    want = {n: s for n, s, _ in specs}
    bns = _bn_layers(want)
    assert len(bns) == 2 * 2 + 3
    for layer in bns:
        for stat in ("running_mean", "running_var"):
            want[f"{layer}.{stat}"] = want[f"{layer}.weight"]
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    for layer in bns:
        for leaf, fill in (("weight", 1.0), ("bias", 0.0),
                           ("running_mean", 0.0), ("running_var", 1.0)):
            v = params[f"{layer}.{leaf}"]
            assert torch.equal(v, torch.full_like(v, fill)), (layer, leaf)
    # the harness's check: every float entry of the state dict, no more
    have = {k for k, t in model.state_dict().items() if t.is_floating_point()}
    assert have == set(params)


def test_fused_tower_refuses_the_family():
    env = make_env("connect4")
    for family, fused in (("resnet", True), ("resnet_bn", False)):
        model = build_model(ModelConfig(family=family, channels=64,
                                        blocks=2), env)
        assert supports_fused_resnet(model) is fused
        assert isinstance(model, ResNetBN) is (not fused)
