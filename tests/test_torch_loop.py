"""The port's outer iteration on the CPU, with the JAX trainer's bookkeeping
(tests/test_arena_loop.py): acceptance promotes the contender and bumps
``version``; rejection reverts ``params_new`` to the best parameters bit
for bit and counts the rejection; collection doubles after
``reject_double_after`` rejections; a due vanilla sanity match plays
vanilla (rollout) search and reports the model's rate."""

import numpy as np
import pytest
import torch

from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.eval import arena
from alphazero_tpu_torch.search.mcts import run_mcts
from alphazero_tpu_torch.training import Trainer


def _cfg(**train):
    t = dict(batch_size=16, selfplay_batch=4, games_per_iter=4, gate_games=4,
             selfplay_chunk_steps=16, train_steps_per_iter=3, seed=3)
    t.update(train)
    return tcfg.Config(
        env="connect4",
        mcts=tcfg.MCTSConfig(num_simulations=6, dirichlet_alpha=0.3,
                             temperature_moves=4),
        model=tcfg.ModelConfig(family="dense", width=64, blocks=1),
        replay=tcfg.ReplayConfig(capacity=42 * 32),
        train=tcfg.TrainConfig(**t))


def _same(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("threshold", [-1.0, 2.0])
def test_iterate_promotes_or_reverts(threshold, monkeypatch):
    trace = []

    def traced(env, eval_fn, boards, players, move_counts, dones, cfg, **kw):
        res = run_mcts(env, eval_fn, boards, players, move_counts, dones,
                       cfg, **kw)
        trace.append((dones, res.visit_counts))
        return res

    monkeypatch.setattr(arena, "run_mcts", traced)
    tr = Trainer(_cfg(gate_threshold=threshold), device="cpu")
    init = {k: v.clone() for k, v in tr.params_best.items()}
    m = tr.iterate(vanilla_eval=False)
    assert m["games"] >= 4 and m["steps"] == 3 and np.isfinite(m["loss"])
    assert sum(tr.last_gate_score[:2]) == 4
    assert len(trace) == 2 * tr.env.max_moves
    for done, counts in trace:
        sums = counts.sum(-1)
        assert (sums[~done] == 5).all() and (sums[done] == 0).all()
    if threshold < 0:
        assert m["accepted"] and tr.version == 1 and tr.reject_count == 0
        assert _same(tr.params_best, tr.params_new)
        assert not _same(tr.params_best, init)
    else:
        assert not m["accepted"] and tr.version == 0 and tr.reject_count == 1
        assert _same(tr.params_new, init) and _same(tr.params_best, init)


def test_rejections_double_collection():
    tr = Trainer(_cfg(gate_threshold=2.0, reject_double_after=1,
                      train_steps_per_iter=1), device="cpu")
    tr.iterate(vanilla_eval=False)
    before = int(tr.sp.games_done)
    m = tr.iterate(vanilla_eval=False)
    assert tr.reject_count == 2 and int(tr.sp.games_done) - before >= 8
    assert m["games"] >= 8


def test_disabled_gate_accepts_and_due_vanilla_match_raises():
    """The due vanilla match no longer raises: it runs after the promotion
    and its rate is in the iteration's result."""
    tr = Trainer(_cfg(gate_enabled=False, vanilla_eval_every=1,
                      train_steps_per_iter=1), device="cpu")
    m = tr.iterate(vanilla_eval=True)
    assert tr.version == 1 and tr.gate() == 1.0
    assert 0.0 <= m["vanilla_win_rate"] <= 1.0
    assert sum(tr.last_vanilla_score[:2]) == 2
    assert "vanilla_win_rate" not in tr.iterate(vanilla_eval=False)
