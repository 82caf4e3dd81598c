"""The ``gomoku15-alphazero`` configuration and the program's network of
it: the harness's weights, the reference's parameters plus the state it
calibrates, fit the port's batch-norm tower by name and shape, at the
configuration's model block cut to small widths on the CPU."""

import copy
import types

import torch

from alphazero_tpu_torch.config import ModelConfig
from alphazero_tpu_torch.envs import make_env
from alphazero_tpu_torch.models import build_model
from azbench import harness, spec
from azbench.harness import Run

CELL = "gomoku15-alphazero.selfplay-deep"


def test_weights_fit_the_ports_model():
    cell = spec.load_cell(CELL)
    conf = copy.deepcopy(cell.config["config"])
    conf["model"].update(channels=16, blocks=2)
    r = Run(cell=types.SimpleNamespace(config={"config": conf}),
            seed=2 ** 31 + 5, seconds=0.0, trace=False,
            device=torch.device("cpu"))
    model = build_model(ModelConfig(**conf["model"]), make_env(conf["env"]))
    params = harness.weights(r, model)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(t.shape) for k, t in model.state_dict().items()
        if t.is_floating_point()}
    assert any(k.endswith("running_var") for k in params)
