"""The readers of the metrics the program's spans feed: each gives its
number from handmade totals and None where nothing was recorded, or where
the program has no recorder (a parent that predates it); on the card the
spans stay off the device operations of a traced stretch."""

import pytest
import torch

from azbench import spec
from alphazero_tpu_torch.utils import profiling

NEW = ["sim_loop_us.selfplay", "sim_loop_us.play",
       "forward_host_us.selfplay", "search_setup_ms.play",
       "readback_ms.play"]

# {name: (count, total_s, self_s, n)}: 2 moves of 200 simulations
TOTALS = {"play.move": (2, 0.050, 0.001, 0),
          "play.readback": (2, 0.004, 0.004, 0),
          "search.move": (2, 0.044, 0.001, 0),
          "search.prepare": (4, 0.003, 0.003, 0),
          "search.root": (2, 0.001, 0.0005, 0),
          "search.sims": (2, 0.0398, 0.0398, 398),
          "search.finish": (4, 0.0002, 0.0002, 0),
          "model.forward": (2, 0.0005, 0.0005, 0)}

WANT = {"sim_loop_us.selfplay": 100.0, "sim_loop_us.play": 100.0,
        "forward_host_us.selfplay": 250.0, "search_setup_ms.play": 2.0,
        "readback_ms.play": 2.0}


@pytest.mark.parametrize("name", NEW)
def test_reader_from_handmade_totals(name, monkeypatch):
    monkeypatch.setattr(profiling, "totals", lambda: dict(TOTALS))
    assert spec.reader(name)(None) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_reader_of_nothing_recorded_is_none(name, monkeypatch):
    monkeypatch.setattr(profiling, "totals", lambda: {})
    assert spec.reader(name)(None) is None
    monkeypatch.delattr(profiling, "totals")       # a program without spans
    assert spec.reader(name)(None) is None


def test_every_new_metric_is_read_where_it_is_listed():
    cells = {m["name"]: m for name in ("connect4.selfplay",
                                       "gomoku7-reference.selfplay",
                                       "connect4.play")
             for m in spec.load_cell(name).per_layer}
    for name in NEW:
        assert cells[name]["source"] == "program_span"


def test_readers_of_a_profiled_cpu_move():
    """Spans recorded for real (a connect4 agent move under a CPU
    profiler) give every play reader a positive number."""
    from torch.profiler import ProfilerActivity, profile
    from alphazero_tpu_torch import config as tcfg
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.eval.play import agent_move
    from alphazero_tpu_torch.models import (build_model, init_params,
                                            make_eval_fn)
    env = make_env("connect4")
    model = build_model(tcfg.ModelConfig(family="dense", width=64, blocks=1),
                        env)
    params = init_params(model, torch.Generator().manual_seed(0))
    cfg = tcfg.MCTSConfig(num_simulations=8, use_dirichlet=False)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            agent_move(env, make_eval_fn(model, params), env.init(1),
                       torch.Generator().manual_seed(1), cfg, verbose=False)
    assert profiling.totals()["search.sims"][3] == 2 * 7
    for name in ("sim_loop_us.play", "search_setup_ms.play",
                 "readback_ms.play", "forward_host_us.selfplay"):
        assert spec.reader(name)(None) > 0, name
    profiling.reset()


@pytest.mark.cuda
def test_spans_are_no_device_operation_on_the_card():
    """A profiled agent move on the card: the trace's device operations
    hold no span name (the profiler's copies of host spans on the device's
    timeline are annotations), and every span was recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from azbench import trace
    from alphazero_tpu_torch import config as tcfg
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.eval.play import agent_move
    from alphazero_tpu_torch.models import (build_model, init_params,
                                            make_eval_fn)
    dev = torch.device("cuda")
    cfg = tcfg.preset("connect4")
    env = make_env(cfg.env)
    model = build_model(cfg.model, env).to(dev)
    params = init_params(model, torch.Generator().manual_seed(0))
    params = {k: v.to(dev) for k, v in params.items()}
    mcfg = tcfg.MCTSConfig(num_simulations=cfg.mcts.num_simulations,
                           use_dirichlet=False)
    eval_fn = make_eval_fn(model, params)

    def moves():
        for _ in range(3):
            agent_move(env, eval_fn, env.init(1, dev),
                       torch.Generator(device=dev).manual_seed(1), mcfg,
                       verbose=False)
    moves()
    profiling.reset()
    t = trace.profile(moves, dev)
    names = set(profiling.totals())
    assert {"play.move", "play.readback", "search.move", "search.sims",
            "model.forward"} <= names
    assert not [k for k in t.kernels if any(n in k for n in names)]
    assert 0 < t.busy_s < t.window_s
    profiling.reset()
