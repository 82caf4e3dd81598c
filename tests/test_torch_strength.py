"""The train-to-strength recipes (``alphazero_tpu_torch/strength.py``)
against the JAX package's ``scripts/train_*.py`` and
``scripts/validate_learning.py``, on the CPU.

* Each recipe's ``Config`` equals, field for field, the config its JAX
  script builds from ``alphazero_tpu.config.preset`` (the scripts run on
  import, so the test builds their configs as they do), and its run
  settings are the script's.
* A tiny ``validate_learning`` run (ResNet 8×1, S=8, 16 games, 1
  iteration, 4 evaluation games) through ``main([..., "--device",
  "cpu"])`` prints the script's lines in its order with its keys, each
  score summing to the games; a second run in the same workdir resumes.
* The verdict is JAX's ``rN > max(0.5, r0)``, edges included.
"""

import dataclasses
import json

import pytest
import torch

from alphazero_tpu import config as jcfg
from alphazero_tpu_torch import strength


def _jax_validate():
    cfg = jcfg.preset("tictactoe")
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, games_per_iter=512, gate_enabled=False))


def _jax_dense(blocks):
    cfg = jcfg.preset("connect4")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, blocks=blocks))


# recipe → (options, the script's config, its settings: iterations, eval
# games, eval every, vanilla sims, sampling moves, eval seed, workdir)
SCRIPTS = {
    "validate_learning": ({}, _jax_validate,
                          (6, 64, None, 200, 2, 123, "runs/ttt_validate")),
    "train_connect4": ({}, lambda: jcfg.preset("connect4"),
                       (60, 64, 10, 400, 4, 7, "runs/c4")),
    "train_connect4_dense": ({}, lambda: dataclasses.replace(
        jcfg.preset("connect4"), model=jcfg.ModelConfig(
            family="dense", width=512, blocks=3)),
        (60, 64, 10, 400, 4, 7, "runs/c4_dense")),
    "train_dense2": ({"blocks": 2}, lambda: _jax_dense(2),
                     (60, 256, 10, 400, 4, 7, "runs/c4_dense2")),
    "train_gomoku9": ({}, lambda: jcfg.preset("gomoku9"),
                      (20, 64, 5, 400, 4, 7, "runs/gomoku9")),
    "train_gomoku9_dense": ({}, lambda: dataclasses.replace(
        jcfg.preset("gomoku9"), model=jcfg.ModelConfig(
            family="dense", width=512, blocks=2)),
        (20, 64, 5, 400, 4, 7, "runs/gomoku9-dense")),
    "train_gomoku7_reference": ({}, lambda: jcfg.preset("gomoku7-reference"),
                                (20, 64, 5, 400, 4, 7,
                                 "runs/gomoku7-reference")),
}


def test_every_script_has_a_recipe():
    assert set(strength.RECIPES) == set(SCRIPTS)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_recipe_config_equals_the_jax_scripts(name):
    options, jax_config, settings = SCRIPTS[name]
    r = strength.RECIPES[name]
    assert dict(r.options) == options
    assert dataclasses.asdict(r.config(**options)) == dataclasses.asdict(
        jax_config())
    assert (r.iterations, r.eval_games, r.eval_every, r.vanilla_sims,
            r.sampling_moves, r.eval_seed,
            r.workdir.format(**options)) == settings


def test_dense2_blocks_argument_builds_the_scripts_config(monkeypatch):
    """``train_dense2 [iters] [blocks]``: the config and workdir of
    ``BLOCKS``, the recipe's 256 evaluation games; other recipes take
    ``[iters] [eval_games]``; one positional argument too many exits."""
    seen = []

    class Fake:
        def __init__(self, recipe, cfg, workdir, eval_games, **kw):
            seen.append((cfg, workdir, eval_games, kw["device"]))

        def run(self, iters):
            seen.append(iters)

    monkeypatch.setattr(strength, "Strength", Fake)
    strength.main(["train_dense2", "5", "3", "--device", "cpu"])
    cfg, workdir, games, dev = seen[0]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_jax_dense(3))
    assert (workdir, games, dev.type, seen[1]) == ("runs/c4_dense3", 256,
                                                   "cpu", 5)
    seen.clear()
    strength.main(["train_gomoku9", "7", "32", "--device", "cpu",
                   "--workdir", "w"])
    assert seen[0][1:3] == ("w", 32) and seen[1] == 7
    with pytest.raises(SystemExit):
        strength.main(["train_gomoku9", "1", "2", "3", "--device", "cpu"])


VALIDATE = strength.RECIPES["validate_learning"]


def _tiny_validate():
    cfg = VALIDATE.config()
    return dataclasses.replace(
        cfg, mcts=dataclasses.replace(cfg.mcts, num_simulations=8),
        model=dataclasses.replace(cfg.model, channels=8, blocks=1),
        train=dataclasses.replace(cfg.train, games_per_iter=16,
                                  selfplay_batch=16, batch_size=64),
        replay=dataclasses.replace(cfg.replay, capacity=288))


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """Two tiny ``validate_learning`` runs in one workdir, through
    ``main`` with ``--device cpu`` and ``--results``: the results file
    after each."""
    tmp = tmp_path_factory.mktemp("strength")
    results = tmp / "validate_learning.jsonl"
    argv = ["validate_learning", "1", "4", "--device", "cpu", "--workdir",
            str(tmp / "wd"), "--results", str(results)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    recipe = dataclasses.replace(VALIDATE, config=_tiny_validate)
    files = []
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(strength.RECIPES, "validate_learning", recipe)
            for _ in range(2):
                strength.main(argv)
                files.append([json.loads(line) for line in
                              results.read_text().splitlines()])
    finally:
        torch.set_num_threads(n)
    return files


EVAL_KEYS = {"tag", "version", "games", "model_score_vs_vanilla200", "score",
             "seconds"}
ITER_KEYS = {"iter", "version", "accepted", "gate_rate", "games", "buffer",
             "env_steps_per_s", "loss", "collect_seconds", "train_seconds",
             "gate_seconds"}


def _check_eval(line, tag, version):
    assert set(line) == EVAL_KEYS
    assert (line["tag"], line["version"], line["games"]) == (tag, version, 4)
    best, model, draws = line["score"]
    assert best + model == 4 and 0 <= draws <= 4
    assert line["model_score_vs_vanilla200"] == model / 4


def test_tiny_validate_learning_lines(tiny_runs):
    note, *lines = tiny_runs[0]
    assert note["recipe"] == "validate_learning" and note["card"] == "cpu"
    assert note["wall_seconds"] > 0
    assert [next(iter(line)) for line in lines] == [
        "resumed", "tag", "iter", "tag", "result"]
    resumed, untrained, it, trained, result = lines
    assert resumed == {"resumed": False, "version": 0}
    _check_eval(untrained, "untrained", 0)
    assert set(it) == ITER_KEYS
    assert (it["iter"], it["version"], it["accepted"],
            it["gate_rate"]) == (1, 1, True, 1.0)   # the gate is off
    _check_eval(trained, "trained", 1)
    r0 = untrained["model_score_vs_vanilla200"]
    rn = trained["model_score_vs_vanilla200"]
    assert result == {"result": "PASS" if rn > max(0.5, r0) else "WEAK",
                      "untrained": r0, "trained": rn}


def test_tiny_validate_learning_resumes(tiny_runs):
    first, second = tiny_runs
    assert second[1:len(first)] == first[1:]      # the file is continued
    assert second[0]["wall_seconds"] > first[0]["wall_seconds"]
    lines = second[len(first):]
    assert [next(iter(line)) for line in lines] == [
        "resumed", "iter", "tag", "result"]
    resumed, it, trained, result = lines
    assert resumed == {"resumed": True, "version": 1}
    assert (it["iter"], it["version"]) == (2, 2)
    _check_eval(trained, "trained", 2)
    assert result == {"result": strength.verdict(
        None, trained["model_score_vs_vanilla200"]), "untrained": None,
        "trained": trained["model_score_vs_vanilla200"]}


@pytest.mark.parametrize("r0, rn", [
    (0.3203125, 0.6171875), (0.5, 0.5), (0.5, 0.5000001), (0.0, 0.5),
    (0.0, 0.515625), (0.6, 0.6), (0.6, 0.59), (0.6, 0.61), (0.75, 0.7),
    (1.0, 1.0), (0.0, 0.0), (0.49, 0.495)])
def test_verdict_is_the_scripts_rule(r0, rn):
    assert strength.verdict(r0, rn) == ("PASS" if rn > max(0.5, r0)
                                        else "WEAK")


@pytest.mark.parametrize("rn, want", [(0.5, "WEAK"), (0.515625, "PASS")])
def test_verdict_of_a_resumed_run_has_only_the_half_to_beat(rn, want):
    assert strength.verdict(None, rn) == want
