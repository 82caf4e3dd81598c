"""The port stands alone: no JAX, nothing of the JAX package, and no quiet
move to the CPU."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

import alphazero_tpu_torch

PKG = pathlib.Path(alphazero_tpu_torch.__file__).parent
ROOT = PKG.parent


def test_import_loads_neither_jax_nor_the_jax_package():
    """Every module of the package, found by walking it, so that a module
    added later is held to the rule too."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import alphazero_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'flax' or m.startswith('flax.') or "
        "m == 'alphazero_tpu' or m.startswith('alphazero_tpu.'))\n"
        "print(len(names), repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]"
    modules = [p for p in PKG.rglob("*.py")]
    assert int(n) == len(modules) - 1      # every module but the package's own


def test_sources_never_name_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax)\b|alphazero_tpu\.",
                     re.MULTILINE)
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    files.append(ROOT / "chip_smoke.py")
    files.append(ROOT / "tests" / "test_torch_ranks.py")    # spawned ranks' module
    assert len(files) > 10
    for p in files:
        text = p.read_text().replace("alphazero_tpu_torch", "")
        hits = [m.group(0) for m in pat.finditer(text)]
        assert not hits, (p, hits)


@pytest.mark.parametrize("entry", ["trainer", "chunk", "buffer", "selfplay",
                                   "move_search", "compare", "symmetries",
                                   "resnet_trainer", "vit_trainer",
                                   "sim_search",
                                   "xla_search", "vanilla_search",
                                   "leaf_batch_search", "cli_train",
                                   "cli_eval", "play", "bench",
                                   "spmd_trainer", "cli_train_mesh",
                                   "strength"])
def test_entry_points_raise_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    from alphazero_tpu_torch import bench, cli, strength
    from alphazero_tpu_torch import config as tcfg
    from alphazero_tpu_torch.data import Symmetries, create
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.eval import Agent, compare
    from alphazero_tpu_torch.eval.play import play_against_agent
    from alphazero_tpu_torch.search.fused import (run_mcts_fused,
                                                  run_selfplay_chunk)
    from alphazero_tpu_torch.search.mcts import run_mcts, run_mcts_xla
    from alphazero_tpu_torch.search.sim import run_mcts_sim
    from alphazero_tpu_torch.training import Trainer, init_selfplay
    from alphazero_tpu_torch.training.spmd_loop import SpmdTrainer
    env = make_env("connect4")
    z = torch.zeros(2, dtype=torch.int32)
    roots = (torch.zeros((2, 2, 6, 7), dtype=torch.int8), z, z,
             torch.zeros(2, dtype=torch.bool))
    calls = {
        "trainer": lambda: Trainer(tcfg.preset("connect4")),
        "chunk": lambda: run_selfplay_chunk(
            env, None, None, torch.zeros((2, 2, 6, 7), dtype=torch.int8),
            torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
            tcfg.MCTSConfig(num_simulations=4), 1),
        "buffer": lambda: create(env, 420),
        "selfplay": lambda: init_selfplay(env, 2, 0),
        "move_search": lambda: run_mcts_fused(
            env, None, None, None, torch.zeros((2, 2, 6, 7), dtype=torch.int8),
            z, z, torch.zeros(2, dtype=torch.bool),
            tcfg.MCTSConfig(num_simulations=4)),
        "compare": lambda: compare(env, Agent(), Agent(), 2),
        "symmetries": lambda: Symmetries(env),
        "resnet_trainer": lambda: Trainer(tcfg.preset("connect4-resnet")),
        "vit_trainer": lambda: Trainer(tcfg.preset("gomoku7-reference")),
        "sim_search": lambda: run_mcts_sim(env, lambda obs: None, *roots,
                                           tcfg.MCTSConfig(num_simulations=4)),
        "xla_search": lambda: run_mcts_xla(env, lambda obs: None, *roots,
                                           tcfg.MCTSConfig(num_simulations=4)),
        "vanilla_search": lambda: run_mcts(env, None, *roots,
                                           tcfg.MCTSConfig(num_simulations=4)),
        "leaf_batch_search": lambda: run_mcts(
            env, lambda obs: None, *roots,
            tcfg.MCTSConfig(num_simulations=9, leaf_batch=4)),
        "cli_train": lambda: cli.main(["train", "--preset", "tictactoe",
                                       "--iterations", "1"]),
        "cli_eval": lambda: cli.main(["eval", "--preset", "tictactoe"]),
        "play": lambda: play_against_agent(
            env, None, tcfg.MCTSConfig(num_simulations=4), 0),
        "bench": lambda: bench.main(),
        "spmd_trainer": lambda: SpmdTrainer(tcfg.preset("connect4")),
        "cli_train_mesh": lambda: cli.main(["train", "--preset", "tictactoe",
                                            "--mesh", "data=2",
                                            "--iterations", "1"]),
        "strength": lambda: strength.main(["validate_learning"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
