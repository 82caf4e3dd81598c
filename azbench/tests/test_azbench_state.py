"""A network that carries state: AlphaZero's batch-norm ResNet
(``families/resnet_bn.py``) held against an ``nn.Module`` of PyTorch's own
layers on the CPU at 16 × 2 on gomoku9, the state the harness calibrates
from the seed, and its check of the program's buffers."""

from __future__ import annotations

import copy
import types

import pytest
import torch
from torch import nn

from alphazero_tpu_torch.config import ModelConfig
from alphazero_tpu_torch.envs import make_env
from alphazero_tpu_torch.models import build_model
from azbench import check, harness
from azbench.harness import Run
from azbench.reference import games, nets

MODEL = {"family": "resnet_bn", "channels": 16, "blocks": 2}
ENV = "gomoku9"
SEED = 2 ** 31 + 77
CPU = torch.device("cpu")


def run_of(model: dict, env: str, seed: int = SEED, device=CPU) -> Run:
    cell = types.SimpleNamespace(config={"config": {"model": model,
                                                    "env": env}})
    return Run(cell=cell, seed=seed, seconds=0.0, trace=False,
               device=device)


class Block(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(c)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(c)

    def forward(self, h):
        y = torch.relu(self.bn1(self.conv1(h)))
        return torch.relu(h + self.bn2(self.conv2(y)))


class AlphaZeroNet(nn.Module):
    """The published network from PyTorch's layers, written apart from the
    reference: ``(logits, value)`` of ``(B, F, R, C)`` observations."""

    def __init__(self, c: int, blocks: int, g: games.Game):
        super().__init__()
        RC = g.cells
        self.stem = nn.Conv2d(g.feature_dim, c, 3, padding=1, bias=False)
        self.stem_bn = nn.BatchNorm2d(c)
        self.blocks = blocks
        for i in range(blocks):
            self.add_module(f"block_{i}", Block(c))
        self.policy_conv = nn.Conv2d(c, 2, 1, bias=False)
        self.policy_bn = nn.BatchNorm2d(2)
        self.policy_head = nn.Linear(2 * RC, g.action_dim)
        self.value_conv = nn.Conv2d(c, 1, 1, bias=False)
        self.value_bn = nn.BatchNorm2d(1)
        self.value_fc = nn.Linear(RC, c)
        self.value_head = nn.Linear(c, 1)

    def forward(self, obs):
        B = obs.shape[0]
        h = torch.relu(self.stem_bn(self.stem(obs)))
        for i in range(self.blocks):
            h = getattr(self, f"block_{i}")(h)
        p = torch.relu(self.policy_bn(self.policy_conv(h)))
        logits = self.policy_head(p.permute(0, 2, 3, 1).reshape(B, -1))
        v = torch.relu(self.value_bn(self.value_conv(h))).reshape(B, -1)
        v = torch.relu(self.value_fc(v))
        return logits, torch.tanh(self.value_head(v))[:, 0]


def bn_layers(module) -> list:
    return [k for k, m in module.named_modules()
            if isinstance(m, nn.BatchNorm2d)]


def without_bn(module):
    """A copy of ``module`` with every batch norm an identity."""
    out = copy.deepcopy(module)
    for name in bn_layers(out):
        parent, _, leaf = name.rpartition(".")
        setattr(out.get_submodule(parent), leaf, nn.Identity())
    return out


def loaded(params: dict):
    """The module on the harness's dict, in eval mode."""
    g = games.game(ENV)
    module = AlphaZeroNet(MODEL["channels"], MODEL["blocks"], g)
    tracked = {f"{k}.num_batches_tracked" for k in bn_layers(module)}
    assert set(module.state_dict()) - set(params) == tracked
    # (batch norm fills a missing counter in itself, so ``missing`` may
    # not list it)
    missing, unexpected = module.load_state_dict(params, strict=False)
    assert unexpected == [] and set(missing) <= tracked
    return module.eval()


def calls_of(module, obs) -> list:
    with torch.no_grad():
        logits, value = module(obs)
    return [(obs, torch.softmax(logits, -1), value)]


def mean_gap(net, calls) -> float:
    return float(torch.cat(check.logit_gaps(net, calls)).mean())


@pytest.fixture(scope="module")
def drawn():
    """The harness's dict at the seed, the module loaded from it, and
    positions the state was not calibrated on."""
    g = games.game(ENV)
    r = run_of(MODEL, ENV)
    params = harness.weights(r, AlphaZeroNet(MODEL["channels"],
                                             MODEL["blocks"], g))
    obs = harness.random_positions(g, 64, torch.Generator().manual_seed(99),
                                   CPU)
    return r, params, loaded(params), obs


def test_forward_matches_torch_layers(drawn):
    r, params, module, obs = drawn
    assert any(k.endswith("running_var") for k in params)
    with torch.no_grad():
        logits, value = module(obs)
    probs, v = nets.Net(MODEL, r.game, params)(obs)
    torch.testing.assert_close(probs, torch.softmax(logits, -1), rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(v, value, rtol=1e-4, atol=1e-5)


def test_calibrated_forward_is_the_batch_statistics_forward(drawn):
    """On the calibration batch, the forward from the calibrated state is
    the forward that normalises by the batch's own statistics."""
    r, params, module, _ = drawn
    obs = harness.calibration_positions(r)
    assert obs.shape[0] == harness.CALIBRATION_POSITIONS
    with torch.no_grad():
        logits, value = copy.deepcopy(module).train()(obs)
    probs, v = nets.Net(MODEL, r.game, params)(obs)
    torch.testing.assert_close(probs, torch.softmax(logits, -1), rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(v, value, rtol=1e-4, atol=1e-5)


def test_leaving_bn_out_fails_logit_gap(drawn):
    """A program without its batch norms lies beyond ``logit_gap``'s 0.04
    from the reference on the calibrated state, and inside it on
    statistics 0 and 1, under which inference-mode batch norm is nearly
    the identity."""
    r, params, module, obs = drawn
    calls = calls_of(without_bn(module), obs)
    assert mean_gap(nets.Net(MODEL, r.game, params), calls) > 0.04
    flat = {k: (torch.ones_like(v) if k.endswith("running_var") else
                torch.zeros_like(v) if k.endswith("running_mean") else v)
            for k, v in params.items()}
    assert mean_gap(nets.Net(MODEL, r.game, flat), calls) < 0.04
    assert mean_gap(nets.Net(MODEL, r.game, params),
                    calls_of(module, obs)) < 1e-3


def test_state_follows_the_seed(drawn):
    r, params, _, _ = drawn
    g = games.game(ENV)

    def state(seed):
        out = harness.weights(run_of(MODEL, ENV, seed), AlphaZeroNet(
            MODEL["channels"], MODEL["blocks"], g))
        return {k: v for k, v in out.items() if "running" in k}

    again, other = state(SEED), state(SEED + 1)
    want = {k: v for k, v in params.items() if "running" in k}
    assert len(want) == 2 * (2 * MODEL["blocks"] + 3)
    assert all(torch.equal(want[k], again[k]) for k in want)
    assert not any(torch.equal(want[k], other[k]) for k in want)


def test_weights_checks_persistent_float_buffers():
    """The dense tower's ``lines`` is a buffer that is not persistent, so
    it passes; a persistent float buffer the family does not give
    raises."""
    mcfg = ModelConfig(family="dense", width=64, blocks=2)
    env = make_env("connect4")
    model = build_model(mcfg, env)
    assert "lines" in dict(model.named_buffers())
    r = run_of({"family": "dense", "width": 64, "blocks": 2}, "connect4")
    params = harness.weights(r, model)
    assert set(params) == {k for k, _ in model.named_parameters()}
    model.register_buffer("stem_scale", torch.ones(64))
    with pytest.raises(RuntimeError, match="persistent float buffers"):
        harness.weights(r, model)
    model.register_buffer("stem_scale", torch.ones(64), persistent=False)
    harness.weights(r, model)


@pytest.mark.cuda
def test_resnet_bn_reference_on_the_card_matches_the_cpu():
    """At AlphaZero's widths, 256 × 19 on gomoku15, B=256: the state
    calibrated on the card, and the reference's forward on it, on the
    card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    model, g = {"family": "resnet_bn", "channels": 256, "blocks": 19}, \
        games.game("gomoku15")
    params = harness.weights(run_of(model, "gomoku15", device=dev),
                             AlphaZeroNet(256, 19, g))
    obs = harness.random_positions(
        g, 256, torch.Generator(device=dev).manual_seed(5), dev)
    p, v = nets.Net(model, g, params)(obs)
    probs, value = nets.Net(model, g, {k: t.cpu() for k, t in
                                       params.items()})(obs.cpu())
    torch.testing.assert_close(p.cpu(), probs, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v.cpu(), value, rtol=1e-4, atol=1e-5)
