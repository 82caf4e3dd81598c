"""The port's configuration tree serialises like the JAX package's."""

import pytest

from alphazero_tpu import config as jcfg
from alphazero_tpu_torch import config as tcfg

PRESETS = ["tictactoe", "connect4", "connect4-resnet", "gomoku9",
           "gomoku9-dense", "gomoku15", "gomoku7-reference"]


@pytest.mark.parametrize("name", PRESETS)
def test_preset_to_json_identical(name):
    assert tcfg.to_json(tcfg.preset(name)) == jcfg.to_json(jcfg.preset(name))


def test_default_config_and_unknown_preset():
    assert tcfg.to_json(tcfg.Config()) == jcfg.to_json(jcfg.Config())
    with pytest.raises(ValueError):
        tcfg.preset("chess")


def test_port_only_preset_is_the_benchmark_configuration():
    """``gomoku15-alphazero`` (AlphaZero's batch-norm tower, which the JAX
    package lacks) is the configuration its benchmark cell runs."""
    import json
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "azbench" /
            "configs" / "gomoku15-alphazero.json")
    doc = json.loads(path.read_text())
    assert doc["preset"] == "gomoku15-alphazero"
    assert json.loads(tcfg.to_json(tcfg.preset("gomoku15-alphazero"))) == \
        doc["config"]
