"""AlphaZero's batch-norm tower through the learner, the trainer, its
checkpoints and the command line, on the CPU at tiny widths.

* One ``train_step`` (float32) against a module of PyTorch's own layers
  (``nn.Conv2d``, ``nn.BatchNorm2d``, ``nn.Linear``) in training mode on
  the same parameters and batch: the loss, every gradient, and the running
  statistics after the step (momentum 0.1, the unbiased variance).
* The state is no Adam parameter, no gradient leaf and no term of
  ``l2_penalty``; a trainer's epoch moves the contender's statistics and
  leaves the best's.
* A checkpoint holds the state and a resume restores it; ``train
  --model-family resnet_bn`` runs an iteration and exits; ``--mesh``
  refuses the family before it starts a rank.
"""

import pytest
import torch
from torch import nn

from alphazero_tpu_torch import cli
from alphazero_tpu_torch.config import (Config, MCTSConfig, ModelConfig,
                                        ReplayConfig, TrainConfig)
from alphazero_tpu_torch.envs import make_env
from alphazero_tpu_torch.models import build_model, init_params
from alphazero_tpu_torch.training import learner
from alphazero_tpu_torch.training.loop import Trainer
from alphazero_tpu_torch.training.spmd_loop import SpmdTrainer

C, BLOCKS, ENV = 8, 2, "gomoku9"
L2 = 1e-3


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
    port."""

    def __init__(self, env):
        super().__init__()
        RC = env.rows * env.cols
        self.stem = nn.Conv2d(env.feature_dim, C, 3, padding=1, bias=False)
        self.stem_bn = nn.BatchNorm2d(C)
        for i in range(BLOCKS):
            self.add_module(f"block_{i}", Block(C))
        self.policy_conv = nn.Conv2d(C, 2, 1, bias=False)
        self.policy_bn = nn.BatchNorm2d(2)
        self.policy_head = nn.Linear(2 * RC, env.action_dim)
        self.value_conv = nn.Conv2d(C, 1, 1, bias=False)
        self.value_bn = nn.BatchNorm2d(1)
        self.value_fc = nn.Linear(RC, C)
        self.value_head = nn.Linear(C, 1)

    def forward(self, obs):
        B = obs.shape[0]
        h = torch.relu(self.stem_bn(self.stem(obs)))
        for i in range(BLOCKS):
            h = getattr(self, f"block_{i}")(h)
        p = torch.relu(self.policy_bn(self.policy_conv(h)))
        logits = self.policy_head(p.permute(0, 2, 3, 1).reshape(B, -1))
        v = torch.relu(self.value_bn(self.value_conv(h))).reshape(B, -1)
        v = torch.relu(self.value_fc(v))
        return logits, torch.tanh(self.value_head(v))[:, 0]


def _model():
    return build_model(ModelConfig(family="resnet_bn", channels=C,
                                   blocks=BLOCKS, compute_dtype="float32"),
                       make_env(ENV))


def _params(model, seed=0):
    """Seeded weights, with scales, shifts and statistics off their initial
    values so that every term of batch norm shows."""
    g = torch.Generator().manual_seed(seed)
    out = init_params(model, g)
    for k, v in out.items():
        if k.endswith(("running_mean", "bias")):
            out[k] = 0.1 * torch.randn(v.shape, generator=g)
        elif k.endswith("running_var") or "bn" in k:
            out[k] = 1.0 + 0.2 * torch.rand(v.shape, generator=g)
    return out


def _batch(env, n=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    obs = (torch.rand((n, env.feature_dim, env.rows, env.cols),
                      generator=g) < 0.2).float()
    pol = torch.rand((n, env.action_dim), generator=g)
    return obs, pol / pol.sum(-1, keepdim=True), torch.rand(
        n, generator=g) * 2 - 1


def test_train_step_matches_torch_layers_in_training_mode():
    env = make_env(ENV)
    model = _model()
    params = _params(model)
    obs, pol, val = _batch(env)
    ref = AlphaZeroNet(env)
    ref.load_state_dict(params, strict=False)
    ref.train()
    logits, value = ref(obs)
    weights = [p for k, p in ref.named_parameters()
               if k.rsplit(".", 1)[1] != "bias"]
    loss = (-(pol * torch.log_softmax(logits, -1)).sum(-1).mean()
            + ((value - val) ** 2).mean()
            + L2 * sum((w ** 2).sum() for w in weights))
    loss.backward()
    ps = learner.leaf_copies(params)
    opt = learner.make_optimizer(TrainConfig(learning_rate=0.0), ps)
    m = learner.train_step(model, ps, opt, obs, pol, val, L2)
    torch.testing.assert_close(m.loss, loss.detach(), rtol=1e-5, atol=1e-6)
    ref_state = ref.state_dict()
    for k, p in ps.items():
        if learner.is_state(k):
            assert p.grad is None and not p.requires_grad
            torch.testing.assert_close(p, ref_state[k], rtol=1e-5,
                                       atol=1e-6)
            assert not torch.equal(p, params[k]), k
        else:
            want = ref.get_parameter(k).grad
            torch.testing.assert_close(p.grad, want, rtol=1e-4,
                                       atol=1e-5 * float(want.abs().max()))


def test_state_is_no_parameter_of_adam_nor_of_l2():
    model = _model()
    params = _params(model)
    ps = learner.leaf_copies(params)
    state = [k for k in ps if learner.is_state(k)]
    assert len(state) == 2 * (2 * BLOCKS + 3)
    opt = learner.make_optimizer(TrainConfig(), ps)
    in_adam = {id(p) for group in opt.param_groups for p in group["params"]}
    assert in_adam == {id(p) for k, p in ps.items() if k not in state}
    assert not any(ps[k].requires_grad for k in state)
    weights = {k: v for k, v in params.items() if not learner.is_state(k)}
    assert torch.equal(learner.l2_penalty(params),
                       learner.l2_penalty(weights))
    big = dict(params, **{k: params[k] + 100.0 for k in state})
    assert torch.equal(learner.l2_penalty(big), learner.l2_penalty(params))


def _cfg(**train):
    return Config(
        env=ENV,
        mcts=MCTSConfig(num_simulations=4, formula="alphazero",
                        temperature_moves=4),
        model=ModelConfig(family="resnet_bn", channels=C, blocks=1),
        replay=ReplayConfig(capacity=81 * 20),
        train=TrainConfig(batch_size=32, selfplay_batch=4, games_per_iter=1,
                          gate_enabled=False, selfplay_chunk_steps=4,
                          train_steps_per_iter=2, **train))


def test_epoch_moves_the_contenders_statistics_and_a_resume_restores_them(
        tmp_path):
    tr = Trainer(_cfg(), device="cpu", workdir=str(tmp_path))
    tr.collect(1)
    while int(tr.buffer.size) == 0:
        tr.collect(1)
    best = {k: v.clone() for k, v in tr.params_best.items()}
    tr.train_epoch()
    key = "block_0.bn1.running_var"
    assert torch.equal(tr.params_best[key], best[key])
    assert not torch.equal(tr.params_new[key], best[key])
    tr.params_best = {k: v.clone() for k, v in tr.params_new.items()}
    tr.version = 1
    tr.save_checkpoint()
    again = Trainer(_cfg(), device="cpu", workdir=str(tmp_path))
    assert torch.equal(again.params_best[key], best[key])
    assert again.restore_checkpoint()
    for k, v in tr.params_best.items():
        assert torch.equal(again.params_best[k], v), k
        assert torch.equal(again.params_new[k], tr.params_new[k]), k


TINY = ["--preset", "gomoku15-alphazero", "--device", "cpu", "--sims", "4",
        "--selfplay-batch", "4", "--games-per-iter", "1", "--batch-size",
        "32", "--model-family", "resnet_bn", "--model-channels", "8",
        "--model-blocks", "1", "--capacity", "2250"]


def test_cli_trains_the_family_for_an_iteration(tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = cli.main(["train", *TINY, "--iterations", "1", "--workdir",
                       str(tmp_path)])
    finally:
        torch.set_num_threads(n)
    assert tr.version == 1 and tr.cfg.model.family == "resnet_bn"
    assert (tmp_path / "checkpoints" / "1" / "state.pt").exists()
    assert any(learner.is_state(k) for k in tr.params_best)


def test_mesh_refuses_the_family():
    with pytest.raises(ValueError, match="batch-norm"):
        cli.main(["train", *TINY, "--iterations", "1", "--mesh", "data=2"])
    with pytest.raises(ValueError, match="synchronised batch norm"):
        SpmdTrainer(_cfg(), device="cpu")
