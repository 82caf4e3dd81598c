"""The ``gomoku7-reference`` preset's outer loop with a tiny ViT on the CPU.

The preset (gomoku 7×7, ViT, ``formula="reference"``, gate disabled) cut
to embedding 32, 4 heads, 6 simulations and 4 games:
* ``iterate`` collects move by move on the per-simulation engine (no dense
  spec: ``run_mcts`` → ``run_mcts_sim``), trains with dropout on (the
  trainer's dropout generator advances) and promotes (the gate is off);
* ``expand_depth(2)`` keeps block 0, the embedding and the heads of both
  parameter sets, gives both the same new block 1, and rewrites the run's
  ``config.json``; a second ``iterate`` trains the deeper model;
* the checkpoint of version 2 restores into a fresh depth-2 trainer: both
  parameter sets, the buffer and the generators of the samples and of the
  dropout, so a resumed run draws the same masks;
* ``expand_depth`` refuses another family and a smaller depth.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.search import sim
from alphazero_tpu_torch.training import Trainer


def _cfg(depth=1):
    c = tcfg.preset("gomoku7-reference")
    return dataclasses.replace(
        c, mcts=dataclasses.replace(c.mcts, num_simulations=6),
        model=dataclasses.replace(c.model, embed_dim=32, num_heads=4,
                                  depth=depth),
        replay=dataclasses.replace(c.replay, capacity=49 * 16),
        train=dataclasses.replace(c.train, batch_size=16, selfplay_batch=4,
                                  games_per_iter=4, selfplay_chunk_steps=8,
                                  train_steps_per_iter=2, seed=5))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_vit_trainer_iterate_expand_iterate_and_restore(tmp_path,
                                                        monkeypatch):
    searches = []
    real = sim.run_mcts_sim

    def counted(*a, **kw):
        searches.append(a[0].name)
        return real(*a, **kw)

    monkeypatch.setattr(sim, "run_mcts_sim", counted)
    cfg = _cfg()
    assert (cfg.env, cfg.mcts.formula, cfg.train.gate_enabled) == (
        "gomoku", "reference", False)
    wd = str(tmp_path / "run")
    tr = Trainer(cfg, device="cpu", workdir=wd)
    assert type(tr.model).__name__ == "ViT" and tr.model.dropout == 0.1
    drop0 = tr.dropout_generator.get_state()
    m = tr.iterate(vanilla_eval=False)
    assert m["accepted"] and tr.version == 1 and m["steps"] == 2
    assert m["games"] >= 4 and np.isfinite(m["loss"])
    assert searches and set(searches) == {"gomoku7"}
    assert not torch.equal(tr.dropout_generator.get_state(), drop0)

    before = {k: v.clone() for k, v in tr.params_best.items()}
    tr.expand_depth(2)
    assert tr.cfg.model.depth == 2 and tr.model.depth == 2
    assert json.loads((tmp_path / "run" / "config.json").read_text())[
        "model"]["depth"] == 2
    new = set(tr.params_best) - set(before)
    assert new and all(k.startswith("block_1.") for k in new)
    assert set(tr.params_new) == set(tr.params_best)
    for k, v in before.items():
        assert torch.equal(tr.params_best[k], v), k
    for k in new:                       # one draw for both parameter sets
        assert torch.equal(tr.params_best[k], tr.params_new[k]), k

    m2 = tr.iterate(vanilla_eval=False)
    assert m2["accepted"] and tr.version == 2 and np.isfinite(m2["loss"])
    assert any(not torch.equal(tr.params_best[k], before[k]) for k in before)

    fresh = Trainer(_cfg(depth=2), device="cpu", workdir=wd,
                    persist_config=False)
    assert fresh.restore_checkpoint()
    assert fresh.version == 2 and fresh.outer_iter == 2
    for name in ("params_best", "params_new"):
        a, b = getattr(fresh, name), getattr(tr, name)
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    for g in ("generator", "dropout_generator"):
        assert torch.equal(getattr(fresh, g).get_state(),
                           getattr(tr, g).get_state()), g
    assert torch.equal(fresh.buffer.obs, tr.buffer.obs)
    with pytest.raises(ValueError):
        Trainer(_cfg(depth=1), device="cpu", workdir=wd,
                persist_config=False).restore_checkpoint()
    with pytest.raises(ValueError, match="grow"):
        tr.expand_depth(1)


def test_expand_depth_refuses_other_families():
    cfg = tcfg.Config(env="tictactoe",
                      model=tcfg.ModelConfig(family="resnet", channels=8,
                                             blocks=1),
                      train=tcfg.TrainConfig(selfplay_batch=2))
    with pytest.raises(ValueError, match="ViT"):
        Trainer(cfg, device="cpu").expand_depth(2)
