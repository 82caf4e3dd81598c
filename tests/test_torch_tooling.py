"""The port's run tooling against the JAX package's.

* ``config.json``: every preset reads back to itself, a file the JAX
  package wrote reads to the port's preset, and the other way round.
* ``MetricsLogger``: JSON lines ``{"kind", "t", ...}`` on stdout and in the
  file.
* ``CheckpointManager``: ``max_to_keep``, ``latest_step``, a file that
  ``torch.load(weights_only=True)`` reads, ``restore`` raising where a name,
  shape or dtype differs, ``restore_raw``.
* A trainer's checkpoint (saved at its promotion) restores into a fresh
  ``Trainer`` with equal state, and every record kind carries at least the
  JAX trainer's keys.
* ``import_buffer`` copies the same rows as the JAX trainer's ring
  arithmetic, with the ring full and not.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import alphazero_tpu.config as jcfg
import alphazero_tpu.utils.checkpoint as jckpt
from alphazero_tpu.data import create as jcreate
from alphazero_tpu.envs import make_env
from alphazero_tpu.training.loop import Trainer as JTrainer
from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.training import Trainer
from alphazero_tpu_torch.utils.checkpoint import CheckpointManager
from alphazero_tpu_torch.utils.metrics import MetricsLogger

PRESETS = ["tictactoe", "connect4", "connect4-resnet", "gomoku9",
           "gomoku9-dense", "gomoku15", "gomoku7-reference"]

# the fields each record of the JAX trainer carries (training/loop.py)
JAX_KEYS = {
    "collect": {"games", "env_steps", "env_steps_per_s", "sims_per_s",
                "buffer_size", "results", "seconds"},
    "train": {"steps", "loss", "policy_loss", "value_loss", "l2", "seconds"},
    "gate": {"win_rate", "score"},
    "vanilla_eval": {"model_win_rate", "vanilla_sims", "score"},
    "iteration": {"iter", "version", "accepted", "gate_rate", "games",
                  "env_steps", "env_steps_per_s", "sims_per_s",
                  "buffer_size", "results", "seconds", "steps", "loss",
                  "policy_loss", "value_loss", "l2"},
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread while this file runs: its tiny convs gain
    nothing from more, and under several test workers per core each
    parallel region of a conv would wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", PRESETS)
def test_config_json_round_trip_both_packages(name, tmp_path):
    cfg = tcfg.preset(name)
    assert tcfg.from_json(tcfg.to_json(cfg)) == cfg
    jcfg.save_config(jcfg.preset(name), str(tmp_path / "jax"))
    assert tcfg.load_config(str(tmp_path / "jax")) == cfg
    tcfg.save_config(cfg, str(tmp_path / "port"))
    assert jcfg.load_config(str(tmp_path / "port")) == jcfg.preset(name)
    assert tcfg.load_config(str(tmp_path / "none")) is None


def test_metrics_logger_lines(tmp_path, capsys):
    log = MetricsLogger(path=str(tmp_path / "m" / "metrics.jsonl"))
    log.log("collect", games=3, results=[1, 2, 0])
    log.log("gate", win_rate=0.5)
    log.close()
    quiet = MetricsLogger(stdout=False)
    quiet.log("train", loss=1.0)
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    lines = (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x) for x in lines] == out
    assert [r["kind"] for r in out] == ["collect", "gate"]
    assert out[0]["games"] == 3 and out[0]["results"] == [1, 2, 0]
    assert all(isinstance(r["t"], float) and r["t"] >= 0 for r in out)


def test_checkpoint_manager(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore_raw() is None
    for step in (1, 2, 3):
        mgr.save(step, {"w": torch.full((2, 3), float(step)),
                        "sub": {"n": torch.tensor(step)}})
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    raw = torch.load(tmp_path / "ck" / "3" / "state.pt", weights_only=True)
    assert torch.equal(raw["w"], torch.full((2, 3), 3.0))
    like = {"w": torch.zeros(2, 3), "sub": {"n": torch.tensor(0)}}
    got = mgr.restore(like, step=2)
    assert torch.equal(got["w"], torch.full((2, 3), 2.0))
    assert int(mgr.restore_raw()["sub"]["n"]) == 3
    for bad in ({"w": torch.zeros(3, 2), "sub": {"n": torch.tensor(0)}},
                {"w": torch.zeros(2, 3, dtype=torch.float64),
                 "sub": {"n": torch.tensor(0)}},
                {"w": torch.zeros(2, 3), "sub": {"m": torch.tensor(0)}}):
        with pytest.raises(ValueError):
            mgr.restore(bad)


def _cfg(**train):
    t = dict(batch_size=16, selfplay_batch=4, games_per_iter=4, gate_games=4,
             selfplay_chunk_steps=5, train_steps_per_iter=2, seed=1,
             vanilla_eval_every=1, gate_threshold=-1.0)
    t.update(train)
    return tcfg.Config(
        env="tictactoe",
        mcts=tcfg.MCTSConfig(num_simulations=6, dirichlet_alpha=0.35,
                             temperature_moves=2),
        model=tcfg.ModelConfig(family="resnet", channels=8, blocks=1),
        replay=tcfg.ReplayConfig(capacity=9 * 32),
        train=tcfg.TrainConfig(**t))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One promoted iteration of a tiny trainer with a workdir."""
    workdir = str(tmp_path_factory.mktemp("run"))
    log = MetricsLogger(path=f"{workdir}/metrics.jsonl", stdout=False)
    tr = Trainer(_cfg(), device="cpu", workdir=workdir, logger=log)
    saved = []
    save = tr.save_checkpoint

    def save_and_keep():     # the state at the promotion, before the
        save()               # vanilla match draws from the generator
        saved.append({k: (v.clone() if torch.is_tensor(v) else
                          {n: t.clone() for n, t in v.items()})
                      for k, v in tr._state().items()})

    tr.save_checkpoint = save_and_keep
    tr.iterate()
    log.close()
    return tr, workdir, saved


def test_checkpoint_restores_equal_state(trained):
    tr, workdir, saved = trained
    assert tr.version == 1 and tr._ckpt.latest_step() == 1 and len(saved) == 1
    assert tcfg.load_config(workdir) == tr.cfg
    fresh = Trainer(tr.cfg, device="cpu", workdir=workdir,
                    persist_config=False, logger=MetricsLogger(stdout=False))
    assert not torch.equal(fresh.params_best["stem.weight"],
                           tr.params_best["stem.weight"])
    assert fresh.restore_checkpoint()
    got, want = fresh._state(), saved[0]
    assert set(got) == set(want)
    for k in want:
        if torch.is_tensor(want[k]):
            assert torch.equal(got[k], want[k]), k
        else:
            assert set(got[k]) == set(want[k]), k
            for n in want[k]:
                assert torch.equal(got[k][n], want[k][n]), (k, n)
    assert (fresh.version, fresh.outer_iter) == (1, 1)
    other = Trainer(_cfg(), device="cpu", workdir=workdir,
                    persist_config=False, logger=MetricsLogger(stdout=False))
    other.buffer.obs = other.buffer.obs[:-1]
    with pytest.raises(ValueError):
        other.restore_checkpoint()


def test_record_kinds_carry_the_jax_keys(trained):
    _, workdir, _ = trained
    with open(f"{workdir}/metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["kind"] for r in recs] == ["collect", "train", "gate",
                                         "vanilla_eval", "iteration"]
    for r in recs:
        assert JAX_KEYS[r["kind"]] | {"kind", "t"} <= set(r), r["kind"]


@pytest.mark.parametrize("size,cursor,dest_blocks", [(5, 5, 3), (10, 4, 6)])
def test_import_buffer_rows_match_jax(size, cursor, dest_blocks, tmp_path,
                                      monkeypatch):
    """Source ring of 10 blocks: partly filled, then full and wrapped."""
    rng = np.random.RandomState(size)
    src = {"obs": rng.randint(0, 2, (10, 9, 3, 3, 3)).astype(np.int8),
           "policy": rng.rand(10, 9, 9).astype(np.float32),
           "length": rng.randint(5, 10, 10).astype(np.int32),
           "winner": rng.randint(-1, 2, 10).astype(np.int32),
           "cursor": np.int32(cursor), "size": np.int32(size)}

    class FakeManager:
        def __init__(self, directory):
            pass

        def restore_raw(self, step=None):
            return {"buffer": src}

    monkeypatch.setattr(jckpt, "CheckpointManager", FakeManager)
    # the JAX method on an object holding only its buffer
    jt = SimpleNamespace(buffer=jcreate(make_env("tictactoe"),
                                        9 * dest_blocks))
    kj = JTrainer.import_buffer(jt, "unused")

    CheckpointManager(str(tmp_path / "checkpoints")).save(0, {"buffer": {
        k: torch.as_tensor(v) for k, v in src.items()}})
    cfg = _cfg()
    cfg = tcfg.Config(env=cfg.env, mcts=cfg.mcts, model=cfg.model,
                      replay=tcfg.ReplayConfig(capacity=9 * dest_blocks),
                      train=cfg.train)
    tr = Trainer(cfg, device="cpu", logger=MetricsLogger(stdout=False))
    kt = tr.import_buffer(str(tmp_path))
    assert kt == kj == min(size, dest_blocks)
    for f in ("obs", "policy", "length", "winner", "cursor", "size"):
        np.testing.assert_array_equal(np.asarray(getattr(jt.buffer, f)),
                                      getattr(tr.buffer, f).numpy(),
                                      err_msg=f)


def test_trace_writes_a_chrome_trace(tmp_path):
    from alphazero_tpu_torch.utils.profiling import span, spans, trace
    with trace(str(tmp_path / "prof")):
        with span("matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = list((tmp_path / "prof").glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "matmul" for e in events)
    assert [s.name for s in spans()] == ["matmul"]
    with trace(None):                   # no directory: nothing recorded
        pass
