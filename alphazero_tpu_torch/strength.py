"""Train to strength: the JAX package's learning-validation scripts.

  python -m alphazero_tpu_torch.strength <recipe> [iters] [eval_games]
      [--device cuda|cpu] [--workdir DIR] [--results PATH]

(``train_dense2`` takes ``[iters] [blocks]``, as its script does.)  One
recipe per script of the JAX package's ``scripts/``: ``validate_learning``,
``train_connect4``, ``train_connect4_dense``, ``train_dense2``,
``train_gomoku9``, ``train_gomoku9_dense`` and ``train_gomoku7_reference``.
The scripts differ only in their settings (:data:`RECIPES`).

A run builds the recipe's ``Trainer`` on its workdir and resumes the
workdir's latest checkpoint when there is one.  It prints, one JSON object
a line:

* ``{"resumed", "version", ...}``, with the field the script adds
  (``blocks``, ``leaf_batch`` or ``gate_enabled``);
* on a fresh run, the ``untrained`` evaluation;
* one line per ``Trainer.iterate(vanilla_eval=False)``: ``iter``,
  ``version``, ``accepted``, ``gate_rate``, ``games``, ``buffer``,
  ``env_steps_per_s``, ``loss`` (rounded as the scripts round them) and
  the seconds of collect, train and gate;
* every ``eval_every`` outer iterations an evaluation tagged ``iter<i>``
  (``i`` the trainer's ``outer_iter``, which a resumed run carries on:
  the scripts count this run's iterations, the same on a fresh run), and
  one at the end (``final``; ``trained`` for ``validate_learning``), each
  followed by a checkpoint;
* for ``validate_learning``, the verdict ``{"result": "PASS"|"WEAK",
  "untrained", "trained"}`` under the script's rule (:func:`verdict`).

An evaluation plays the best parameters against vanilla search with random
rollouts (``eval.arena.compare`` with visit sampling for the first
``sampling_moves`` moves; every draw from one ``torch.Generator`` seeded
with the recipe's eval seed) and prints ``tag``, ``version``, ``games``,
``model_score_vs_vanilla<sims>`` (the network's score, draws 0.5),
``score`` ([vanilla, network, draws]) and its wall ``seconds``.  As in the
JAX scripts, both agents are built with ``use_dirichlet=False``, which the
arena's agents override: arena searches keep root noise on.

``--results PATH`` also writes every line to ``PATH`` after a first note
line (the card's name and power limit as ``nvidia-smi`` gives them, the
commit when the checkout is a git repository, the run's wall seconds so
far), rewritten after each line.  ``AZ_FUSED_RESNET=1`` evaluates ResNet
models through the fused tower kernel, as in ``cli.py``.  The run is on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import torch

from alphazero_tpu_torch.cli import fused_resnet_opt_in
from alphazero_tpu_torch.config import (Config, MCTSConfig, ModelConfig,
                                        preset)
from alphazero_tpu_torch.device import resolve_device
from alphazero_tpu_torch.eval.arena import Agent, compare
from alphazero_tpu_torch.models import make_eval_fn
from alphazero_tpu_torch.training.loop import Trainer
from alphazero_tpu_torch.utils.metrics import MetricsLogger


@dataclasses.dataclass(frozen=True)
class Recipe:
    """One script's settings.  ``config(**options)`` builds its ``Config``
    as the script does; ``args`` names the positional arguments, and
    ``options`` those of them that are neither ``iters`` nor
    ``eval_games``, with their defaults (passed to ``config`` and to the
    ``workdir`` template); ``eval_every`` None evaluates at the start and
    the end only."""

    config: Callable[..., Config]
    iterations: int
    eval_games: int
    eval_every: Optional[int]
    vanilla_sims: int
    sampling_moves: int
    eval_seed: int
    workdir: str
    args: Tuple[str, ...] = ("iters", "eval_games")
    options: Tuple[Tuple[str, int], ...] = ()
    resumed_keys: Tuple[str, ...] = ()
    verdict: bool = False     # validate_learning's: its last tag "trained"


def _validate_config() -> Config:
    cfg = preset("tictactoe")
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, games_per_iter=512, gate_enabled=False))


def _dense_blocks(blocks: int) -> Config:
    cfg = preset("connect4")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, blocks=blocks))


RECIPES = {
    "validate_learning": Recipe(
        _validate_config, iterations=6, eval_games=64, eval_every=None,
        vanilla_sims=200, sampling_moves=2, eval_seed=123,
        workdir="runs/ttt_validate", verdict=True),
    "train_connect4": Recipe(
        lambda: preset("connect4"), iterations=60, eval_games=64,
        eval_every=10, vanilla_sims=400, sampling_moves=4, eval_seed=7,
        workdir="runs/c4"),
    "train_connect4_dense": Recipe(
        lambda: dataclasses.replace(preset("connect4"), model=ModelConfig(
            family="dense", width=512, blocks=3)),
        iterations=60, eval_games=64, eval_every=10, vanilla_sims=400,
        sampling_moves=4, eval_seed=7, workdir="runs/c4_dense"),
    "train_dense2": Recipe(
        _dense_blocks, iterations=60, eval_games=256, eval_every=10,
        vanilla_sims=400, sampling_moves=4, eval_seed=7,
        workdir="runs/c4_dense{blocks}", args=("iters", "blocks"),
        options=(("blocks", 2),), resumed_keys=("blocks",)),
    "train_gomoku9": Recipe(
        lambda: preset("gomoku9"), iterations=20, eval_games=64,
        eval_every=5, vanilla_sims=400, sampling_moves=4, eval_seed=7,
        workdir="runs/gomoku9", resumed_keys=("leaf_batch",)),
    "train_gomoku9_dense": Recipe(
        lambda: dataclasses.replace(preset("gomoku9"), model=ModelConfig(
            family="dense", width=512, blocks=2)),
        iterations=20, eval_games=64, eval_every=5, vanilla_sims=400,
        sampling_moves=4, eval_seed=7, workdir="runs/gomoku9-dense"),
    "train_gomoku7_reference": Recipe(
        lambda: preset("gomoku7-reference"), iterations=20, eval_games=64,
        eval_every=5, vanilla_sims=400, sampling_moves=4, eval_seed=7,
        workdir="runs/gomoku7-reference", resumed_keys=("gate_enabled",)),
}


def verdict(untrained: Optional[float], trained: float) -> str:
    """``validate_learning``'s rule: PASS when the trained score beats both
    0.5 and the untrained score (on a resumed run, which has no untrained
    score, 0.5 alone)."""
    floor = 0.5 if untrained is None else max(0.5, untrained)
    return "PASS" if trained > floor else "WEAK"


def _field(cfg: Config, name: str):
    """A config field by name, from the section that holds it."""
    for section in (cfg.model, cfg.mcts, cfg.train, cfg.replay):
        if hasattr(section, name):
            return getattr(section, name)
    raise KeyError(name)


def _print_line(line: dict):
    print(json.dumps(line), flush=True)


class Strength:
    """One recipe's run on one trainer.  ``emit`` receives each line's
    record; :meth:`evaluate` and :meth:`iterate` are the steps
    :meth:`run` takes."""

    def __init__(self, recipe: Recipe, cfg: Config, workdir: str,
                 eval_games: int, device="cuda", fused_resnet: bool = False,
                 emit: Callable[[dict], None] = _print_line):
        self.recipe = recipe
        self.cfg = cfg
        self.eval_games = eval_games
        self.emit = emit
        self.tr = Trainer(cfg, device=device, workdir=workdir,
                          logger=MetricsLogger(
                              path=f"{workdir}/metrics.jsonl", stdout=False),
                          fused_resnet=fused_resnet)

    def evaluate(self, tag: str) -> float:
        """The best parameters against vanilla search: emits the line and
        returns the network's score."""
        r, tr = self.recipe, self.tr
        gen = torch.Generator(device=tr.device).manual_seed(r.eval_seed)
        vanilla = Agent(None, MCTSConfig(num_simulations=r.vanilla_sims,
                                         use_dirichlet=False))
        model = Agent(make_eval_fn(tr.model, tr.params_best,
                                   tr.fused_resnet),
                      dataclasses.replace(self.cfg.mcts, use_dirichlet=False))
        t0 = time.perf_counter()
        rate, score = compare(tr.env, vanilla, model, self.eval_games,
                              generator=gen, sampling=True,
                              sampling_moves=r.sampling_moves,
                              device=tr.device)
        line = {"tag": tag, "version": tr.version, "games": self.eval_games,
                f"model_score_vs_vanilla{r.vanilla_sims}": rate,
                "score": score.tolist(),
                "seconds": time.perf_counter() - t0}
        self.emit(line)
        return rate

    def iterate(self) -> dict:
        """One outer iteration without the vanilla sanity match; emits and
        returns the line."""
        m = self.tr.iterate(vanilla_eval=False)
        line = {"iter": m["iter"], "version": m["version"],
                "accepted": m["accepted"],
                "gate_rate": round(m["gate_rate"], 4), "games": m["games"],
                "buffer": m["buffer_size"],
                "env_steps_per_s": round(m["env_steps_per_s"], 1),
                "loss": round(m["loss"], 4),
                **{k: m[k] for k in ("collect_seconds", "train_seconds",
                                     "gate_seconds")}}
        self.emit(line)
        return line

    def run(self, iters: int) -> Optional[dict]:
        """Resume, evaluate, iterate ``iters`` times; the verdict line for a
        recipe that has one."""
        r, tr = self.recipe, self.tr
        resumed = tr.restore_checkpoint()
        self.emit({"resumed": bool(resumed), "version": tr.version,
                   **{k: _field(self.cfg, k) for k in r.resumed_keys}})
        r0 = None if resumed else self.evaluate("untrained")
        for _ in range(iters):
            self.iterate()
            if r.eval_every and tr.outer_iter % r.eval_every == 0:
                self.evaluate(f"iter{tr.outer_iter}")
                tr.save_checkpoint()
        rn = self.evaluate("trained" if r.verdict else "final")
        tr.save_checkpoint()
        if not r.verdict:
            return None
        line = {"result": verdict(r0, rn), "untrained": r0, "trained": rn}
        self.emit(line)
        return line


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _commit() -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             cwd=Path(__file__).resolve().parent,
                             capture_output=True, text=True, timeout=60)
    except OSError:
        return None
    return out.stdout.strip() or None


class ResultsFile:
    """``emit`` for ``--results``: prints each line and rewrites ``path``
    with a note (card, commit, wall seconds) and every line.  A file that
    exists is continued, as a resumed run continues its workdir: its lines
    are kept, the wall seconds add up, and a card or commit that differs
    from the note's is added to it."""

    def __init__(self, path: str, recipe: str, argv: List[str], device):
        self.path = path
        self.lines: List[dict] = []
        self.t0 = time.perf_counter()
        card = card_name() if device.type == "cuda" else "cpu"
        self.note = {"note": "python -m alphazero_tpu_torch.strength "
                             + " ".join(argv),
                     "recipe": recipe, "card": card, "commit": _commit(),
                     "wall_seconds": 0.0}
        if os.path.exists(path):
            with open(path) as f:
                recs = [json.loads(line) for line in f if line.strip()]
            old, self.lines = recs[0], recs[1:]
            for k in ("card", "commit"):
                if old[k] != self.note[k]:
                    old[k] = f"{old[k]}; {self.note[k]}"
            self.note = old
        self.wall0 = self.note["wall_seconds"]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def __call__(self, line: dict):
        _print_line(line)
        self.lines.append(line)
        self.note["wall_seconds"] = (self.wall0 + time.perf_counter()
                                     - self.t0)
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            for rec in [self.note] + self.lines:
                f.write(json.dumps(rec) + "\n")
        os.replace(tmp, self.path)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m alphazero_tpu_torch.strength",
        description="Train to strength against vanilla search (the JAX "
                    "package's scripts/train_*.py and validate_learning.py)")
    ap.add_argument("recipe", choices=sorted(RECIPES))
    ap.add_argument("values", nargs="*", type=int, metavar="N",
                    help="[iters] [eval_games] ([iters] [blocks] for "
                         "train_dense2)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--results", default=None,
                    help="also write the lines, after a note, to this file")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    r = RECIPES[args.recipe]
    if len(args.values) > len(r.args):
        ap.error(f"{args.recipe} takes at most {len(r.args)} positional "
                 f"arguments: {' '.join(r.args)}")
    given = dict(zip(r.args, args.values))
    iters = given.pop("iters", r.iterations)
    eval_games = given.pop("eval_games", r.eval_games)
    options = {**dict(r.options), **given}
    workdir = args.workdir or r.workdir.format(**options)
    argv = sys.argv[1:] if argv is None else list(argv)
    emit = (ResultsFile(args.results, args.recipe, argv, device)
            if args.results else _print_line)
    return Strength(r, r.config(**options), workdir, eval_games,
                    device=device, fused_resnet=fused_resnet_opt_in(),
                    emit=emit).run(iters)


if __name__ == "__main__":
    main()
