"""The port's command line and human play, on the CPU.

* ``python -m alphazero_tpu_torch --help`` lists train, eval, play and bench
  in a process where ``jax`` cannot be imported.
* A tiny ``train --device cpu`` writes ``metrics.jsonl``, ``config.json``
  and a checkpoint; ``train --resume`` goes on from it (version 2) and
  ``eval --vs self`` prints its JSON line.
* ``train --model-family vit`` on a tiny ``gomoku7-reference`` run, then
  ``train --resume --expand-depth 2``: the checkpoint and ``config.json``
  hold the deeper ViT, and ``eval`` and ``play`` restore it from the
  workdir.
* ``--mesh`` specs parse as the JAX package's ``_parse_mesh`` parses them,
  and the bad ones exit with its messages.
* Scripted ``play`` against vanilla search ends in a result;
  ``parse_input`` reads cells and columns; ``agent_move`` plays a legal
  move for a tictactoe ResNet, connect4 and tictactoe dense towers (the
  whole-move search at B=1) and a gomoku ViT.
"""

import json
import subprocess
import sys

import pytest
import torch

from alphazero_tpu_torch import cli
from alphazero_tpu_torch.config import MCTSConfig, ModelConfig
from alphazero_tpu_torch.envs import make_env
from alphazero_tpu_torch.eval import play as play_module
from alphazero_tpu_torch.eval.play import (agent_move, parse_input,
                                           play_against_agent)
from alphazero_tpu_torch.models import build_model, init_params, make_eval_fn
from tests.test_torch_isolation import ROOT

VIT = ["--preset", "gomoku7-reference", "--device", "cpu", "--sims", "4",
       "--selfplay-batch", "4", "--games-per-iter", "4", "--batch-size",
       "256", "--model-family", "vit", "--model-embed-dim", "16",
       "--model-patch-size", "3", "--capacity", "784"]
TINY = ["--preset", "tictactoe", "--device", "cpu", "--sims", "4",
        "--selfplay-batch", "4", "--games-per-iter", "4", "--gate-games", "4",
        "--batch-size", "64", "--model-channels", "8", "--model-blocks", "1",
        "--capacity", "288"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread while this file runs: its tiny convs gain
    nothing from more, and under several test workers per core each
    parallel region of a conv would wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_help_without_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text(
        "raise ImportError('jax is not importable here')\n")
    out = subprocess.run(
        [sys.executable, "-m", "alphazero_tpu_torch", "--help"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{tmp_path}:{ROOT}"})
    assert out.returncode == 0, out.stderr
    for cmd in ("train", "eval", "play", "bench"):
        assert cmd in out.stdout


def test_train_resume_eval(tmp_path, capsys):
    wd = str(tmp_path / "run")
    tr = cli.main(["train", *TINY, "--iterations", "1", "--no-gate",
                   "--workdir", wd])
    assert tr.version == 1
    kinds = [json.loads(x)["kind"] for x in
             (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert kinds == ["collect", "train", "iteration"]
    assert json.loads((tmp_path / "run" / "config.json").read_text())[
        "model"]["channels"] == 8
    assert (tmp_path / "run" / "checkpoints" / "1" / "state.pt").exists()
    tr2 = cli.main(["train", *TINY, "--iterations", "1", "--no-gate",
                    "--resume", "--workdir", wd])
    assert (tr2.version, tr2.outer_iter) == (2, 2)
    capsys.readouterr()
    res = cli.main(["eval", "--preset", "tictactoe", "--device", "cpu",
                    "--workdir", wd, "--vs", "self", "--games", "4"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res and line["games"] == 4
    assert sum(line["score"][:2]) == 4


@pytest.fixture(scope="module")
def vit_run(tmp_path_factory):
    """A ViT run: one iteration, then one more after ``--resume
    --expand-depth 2``; returns the workdir and the second trainer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    wd = str(tmp_path_factory.mktemp("vit") / "run")
    try:
        tr = cli.main(["train", *VIT, "--iterations", "1", "--workdir", wd])
        assert tr.version == 1 and tr.model.depth == 1
        tr2 = cli.main(["train", *VIT, "--iterations", "1", "--resume",
                        "--expand-depth", "2", "--workdir", wd])
    finally:
        torch.set_num_threads(n)
    return wd, tr2


def test_vit_train_then_expand_depth_on_resume(vit_run):
    wd, tr = vit_run
    assert (tr.version, tr.outer_iter) == (2, 2)
    assert type(tr.model).__name__ == "ViT" and tr.model.depth == 2
    assert any(k.startswith("block_1.") for k in tr.params_best)
    cfg = json.loads(open(f"{wd}/config.json").read())["model"]
    assert (cfg["family"], cfg["depth"], cfg["embed_dim"]) == ("vit", 2, 16)
    state = torch.load(f"{wd}/checkpoints/2/state.pt", weights_only=False)
    assert "block_1.mlp_fc1.weight" in state["params_best"]
    assert "dropout_generator" in state


def test_eval_restores_the_expanded_vit(vit_run, capsys):
    wd, _ = vit_run
    capsys.readouterr()
    res = cli.main(["eval", "--preset", "gomoku7-reference", "--device",
                    "cpu", "--workdir", wd, "--vs", "self", "--games", "2"])
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line == res and sum(line["score"][:2]) == 2
    assert "loaded version 2" in out.err


def test_play_restores_the_expanded_vit(vit_run, monkeypatch):
    """``play`` builds its agent from the workdir's ViT: its evaluator
    equals the trained parameters' on a position."""
    wd, tr = vit_run
    seen = {}

    def fake_play(env, eval_fn, mcts_cfg, human_turn, device):
        seen.update(env=env, eval_fn=eval_fn)

    monkeypatch.setattr(play_module, "play_against_agent", fake_play)
    cli.main(["play", "--preset", "gomoku7-reference", "--device", "cpu",
              "--workdir", wd])
    env = seen["env"]
    state = env.step(env.init(1), torch.tensor([24], dtype=torch.int32))
    obs = env.observation(state)
    p, v = seen["eval_fn"](obs)
    wp, wv = make_eval_fn(tr.model, tr.params_best)(obs)
    assert torch.equal(p, wp) and torch.equal(v, wv)


@pytest.mark.parametrize("spec", ["data=0", "model=2", "data=2,data=2",
                                  "foo=1", "data=x", "data=2,model=0"])
def test_parse_mesh_rejects_bad_specs(spec):
    from alphazero_tpu.cli import _parse_mesh as jax_parse_mesh
    with pytest.raises(SystemExit) as want:
        jax_parse_mesh(spec)
    with pytest.raises(SystemExit) as got:
        cli._parse_mesh(spec)
    assert str(got.value.code) == str(want.value.code)


@pytest.mark.parametrize("spec,shape", [("data=8", (8, 1)),
                                        ("data=4,model=2", (4, 2)),
                                        ("model=2,data=1", (1, 2))])
def test_parse_mesh_reads_data_and_model(spec, shape):
    from alphazero_tpu.cli import _parse_mesh as jax_parse_mesh
    assert cli._parse_mesh(spec) == jax_parse_mesh(spec) == shape


def test_parse_input_cell_and_column():
    ttt, c4 = make_env("tictactoe"), make_env("connect4")
    s, s4 = ttt.init(1), c4.init(1)
    assert parse_input(ttt, s, "1 1") == 4
    assert parse_input(ttt, s, "bogus") is None
    assert parse_input(ttt, s, "5 5") is None
    assert parse_input(c4, s4, "3") == 3
    assert parse_input(c4, s4, "9") is None
    s = ttt.step(s, torch.tensor([4], dtype=torch.int32))
    assert parse_input(ttt, s, "1 1") is None          # taken


def test_play_against_vanilla_scripted():
    env = make_env("tictactoe")
    moves = iter(["0 0", "0 1", "1 0", "9 9", "2 2", "1 1", "0 2", "2 0",
                  "2 1", "1 2"])
    outputs = []
    w = play_against_agent(env, None, MCTSConfig(num_simulations=16),
                           human_turn=0, input_fn=lambda _: next(moves),
                           print_fn=outputs.append, device="cpu")
    assert w in (-1, 0, 1)
    assert any("wins" in str(o) or "draw" in str(o) for o in outputs)
    assert "O" in outputs[-2]                       # the final board


@pytest.mark.parametrize("game,family", [("tictactoe", "resnet"),
                                         ("connect4", "dense"),
                                         ("tictactoe", "dense"),
                                         ("gomoku", "vit")])
def test_agent_move_is_legal(game, family):
    env = make_env(game)
    model = build_model(ModelConfig(family=family, channels=8, width=64,
                                    blocks=1, embed_dim=16, num_heads=4,
                                    patch_size=3), env)
    params = init_params(model, torch.Generator().manual_seed(0))
    state = env.init(1)
    state = env.step(state, torch.tensor([0], dtype=torch.int32))
    a = agent_move(env, make_eval_fn(model, params), state,
                   torch.Generator().manual_seed(1),
                   MCTSConfig(num_simulations=16, use_dirichlet=False),
                   verbose=False)
    assert bool(env.valid_mask(state)[0, a])
