"""Whole runs of every cell on the CPU at a tiny size, past the look for a
card: the sound program comes out correct; with the timed path broken
underneath, or the fp8 control in the program's place, it does not.

The faults planted are those a one-chip cell can have: a step that
returns its state unchanged, half of the batch left out, and an answer
altered where it is produced (the exchange between chips does not exist
on one chip; the play cell's batch is one game, so it has no half)."""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from azbench import run as azrun
from azbench import spec
from azbench.harness import Run

SEED = 2 ** 31 + 77


def tiny(name: str, width=64, sims=12, batch=8) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    k = cell.config["config"]
    k["mcts"]["num_simulations"] = sims
    k["train"]["selfplay_batch"] = batch
    k["train"]["selfplay_chunk_steps"] = 4
    k["model"].update(width=width, blocks=1, embed_dim=32, num_heads=4)
    k["replay"]["capacity"] = 42 * 40
    return cell


def execute(cell, control=None, seed=SEED) -> dict:
    r = Run(cell=cell, seed=seed, seconds=0.5, trace=False,
            device=torch.device("cpu"), control=control)
    line, _ = azrun.execute(r)
    return json.loads(line)


CELLS = ["connect4.selfplay", "gomoku7-reference.selfplay", "connect4.play"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = execute(tiny(name))
    assert out["correct"], out
    assert out["attempted"] > 0 and out["failed"] == 0
    cell = spec.load_cell(name)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(out)[-1] == "checks"


def _unchanged(monkeypatch, name):
    """The step returns its state unchanged."""
    if name.endswith(".play"):
        from alphazero_tpu_torch.envs.connect4 import Connect4
        monkeypatch.setattr(Connect4, "step", lambda self, s, a: s)
        return
    from alphazero_tpu_torch.training import loop
    monkeypatch.setattr(loop, "make_selfplay_runner",
                        lambda *a, **k: (lambda params, sp, buf: (sp, buf)))


def _half_chunk(monkeypatch):
    """The whole-chunk search plays the first half of the games; the other
    half get copies of its records."""
    from alphazero_tpu_torch.search import fused
    from alphazero_tpu_torch.training import selfplay
    real = fused.run_selfplay_chunk

    def half(env, model, params, boards, players, mcs, cfg, M, **kw):
        h = boards.shape[0] // 2
        for key in ("noise", "unif"):
            if kw.get(key) is not None:
                kw[key] = kw[key][..., :h].contiguous() if key == "noise" \
                    else kw[key][:, :h].contiguous()
        rec = real(env, model, params, boards[:h], players[:h], mcs[:h], cfg,
                   M, **kw)
        return {k: torch.cat([v, v], dim=0 if k in (
            "board", "player_final", "mc_final") else 1)
            for k, v in rec.items()}

    monkeypatch.setattr(fused, "run_selfplay_chunk", half)
    monkeypatch.setattr(selfplay, "run_selfplay_chunk", half)


def _half_step(monkeypatch):
    """The move-by-move step moves the first half of the games only."""
    from alphazero_tpu_torch.envs.core import EnvState
    from alphazero_tpu_torch.training import selfplay
    real = selfplay.selfplay_step

    def half(env, eval_fn, cfg, sp, buf, **kw):
        nxt, buf = real(env, eval_fn, cfg, sp, buf, **kw)
        h = sp.t.shape[0] // 2

        def mix(a, b):
            return torch.cat([a[:h], b[h:]])

        state = EnvState(*(mix(getattr(nxt.env_state, f.name),
                               getattr(sp.env_state, f.name))
                           for f in dataclasses.fields(EnvState)))
        return dataclasses.replace(nxt, env_state=state, t=mix(nxt.t, sp.t)
                                   ), buf

    monkeypatch.setattr(selfplay, "selfplay_step", half)


def _altered(monkeypatch, name):
    """One answer altered where it is produced."""
    if name == "connect4.selfplay":
        from alphazero_tpu_torch.search import fused
        from alphazero_tpu_torch.training import selfplay
        real = fused.run_selfplay_chunk

        def alter(*a, **kw):
            rec = real(*a, **kw)
            rec["action"][0, 0] = (rec["action"][0, 0] + 1) % 7
            return rec
        monkeypatch.setattr(fused, "run_selfplay_chunk", alter)
        monkeypatch.setattr(selfplay, "run_selfplay_chunk", alter)
    elif name.endswith(".selfplay"):
        from alphazero_tpu_torch.training import selfplay
        real = selfplay.selfplay_step

        def alter(env, eval_fn, cfg, sp, buf, **kw):
            nxt, buf = real(env, eval_fn, cfg, sp, buf, **kw)
            t = int(sp.t[0])
            row = nxt.traj_policy[0, t]
            other = int(torch.nonzero(row == 0).reshape(-1)[0]) \
                if bool((row == 0).any()) else (int(row.argmax()) + 1) % 49
            nxt.traj_policy[0, t] = 0.0
            nxt.traj_policy[0, t, other] = 1.0
            return nxt, buf
        monkeypatch.setattr(selfplay, "selfplay_step", alter)
    else:
        from alphazero_tpu_torch.eval import play
        real = play.run_mcts

        def alter(*a, **kw):
            res = real(*a, **kw)
            c = res.visit_counts
            res.visit_counts = torch.roll(c, 1, dims=-1)
            return res
        monkeypatch.setattr(play, "run_mcts", alter)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_is_not_correct(monkeypatch, name, fault):
    if fault == "half":
        if name.endswith(".play"):
            pytest.skip("the play cell's batch is one game: it has no half")
        (_half_chunk if name.startswith("connect4") else _half_step)(
            monkeypatch)
    elif fault == "unchanged":
        _unchanged(monkeypatch, name)
    else:
        _altered(monkeypatch, name)
    out = execute(tiny(name))
    assert not out["correct"], out


@pytest.mark.parametrize("name", CELLS)
def test_fp8_control_is_not_correct(name):
    """The reference in float8 in the program's place fails the cell's
    number of the forward (``visit_tv``, ``logit_gap``) at a size a test
    run holds (width 256, 48 simulations)."""
    out = execute(tiny(name, width=256, sims=48, batch=16), control="fp8")
    assert not out["correct"]
    number = "logit_gap" if "logit_gap" in out["checks"] else "visit_tv"
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_without_a_card_no_result(tmp_path):
    """Without CUDA the command exits non-zero and prints nothing on
    standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "azbench.run", "--workload",
                          "connect4.play", "--seed", str(SEED), "--seconds",
                          "1", "--trace", "0"], cwd=spec.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    """One short run of each cell on the card comes out correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "azbench.run", "--workload",
                          name, "--seed", str(SEED), "--seconds", "3",
                          "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"]
