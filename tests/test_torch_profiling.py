"""The port's spans (``utils/profiling.py``) on the CPU.

* Off: with no profiler recording, ``span`` is one shared null context and
  nothing is recorded.
* On: under ``torch.profiler``, an agent move on the dense move search
  records ``play.move`` ⊃ ``search.move`` ⊃ its parts and ``play.readback``
  as one request, each span also an event of the profiler with the same
  parent and about the same duration; a ViT self-play step records one
  ``model.forward`` a simulation; a chunk one ``search.move`` a move.
* The searches, the chunk and the step return the same bits with the
  profiler recording as without.
* ``totals`` sums counts, durations, self time and ``n`` by name.
"""

import dataclasses
import gc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alphazero_tpu_torch import config as tcfg
from alphazero_tpu_torch.data import create
from alphazero_tpu_torch.envs import make_env
from alphazero_tpu_torch.eval.play import agent_move
from alphazero_tpu_torch.models import build_model, init_params, make_eval_fn
from alphazero_tpu_torch.search.stub import exact_stub_evaluator
from alphazero_tpu_torch.training import init_selfplay, selfplay_chunk
from alphazero_tpu_torch.training.selfplay import selfplay_step
from alphazero_tpu_torch.utils import profiling
from alphazero_tpu_torch.utils.profiling import span, spans, totals

MOVE_PARTS = {"search.prepare", "search.root", "search.sims",
              "search.finish"}


def _profiled(fn):
    """``fn()`` under a CPU profiler: ``(result, spans, profiler events)``."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(spans()), prof.events()


def _dense_move(S=6):
    env = make_env("connect4")
    model = build_model(tcfg.ModelConfig(family="dense", width=64, blocks=1),
                        env)
    params = init_params(model, torch.Generator().manual_seed(0))
    state = env.step(env.init(1), torch.tensor([3], dtype=torch.int32))
    cfg = tcfg.MCTSConfig(num_simulations=S, use_dirichlet=False)

    def move():
        return agent_move(env, make_eval_fn(model, params), state,
                          torch.Generator().manual_seed(1), cfg,
                          verbose=False)
    return move


def test_span_off_is_one_null_context_and_records_nothing():
    profiling.reset()
    a, b = span("play.move"), span("search.sims", 5)
    assert a is b
    with a:
        with b:
            pass
    _dense_move()()
    assert spans() == [] and totals() == {}


def _duration_misfits(rec, events):
    """Spans whose duration is not within 10% or 50 µs of their profiler
    event's, or whose nearest spanned ancestor event is not their
    parent's."""
    names = {s.name for s in rec}
    prof = {}
    for e in events:
        if e.name in names:
            prof.setdefault(e.name, []).append(e)
    for k in prof:
        prof[k].sort(key=lambda e: e.time_range.start)
    seen, bad = {}, []
    for s in rec:
        k = seen.get(s.name, 0)
        seen[s.name] = k + 1
        e = prof[s.name][k]
        want = e.time_range.elapsed_us()
        got = (s.end_ns - s.start_ns) / 1e3
        if abs(got - want) > max(0.1 * want, 50.0):
            bad.append((s.name, got, want))
        up = e.cpu_parent
        while up is not None and up.name not in names:
            up = up.cpu_parent
        if (up.name if up else None) != (rec[s.parent].name
                                         if s.parent >= 0 else None):
            bad.append((s.name, "parent", up.name if up else None))
    return bad


def test_agent_move_records_the_request_tree_beside_the_profiler():
    S = 6
    move = _dense_move(S)
    _, rec, events = _profiled(move)
    names = [s.name for s in rec]
    assert names[0] == "play.move"
    assert all(s.request == 0 and s.end_ns is not None for s in rec)
    kids = lambda i: {rec[j].name for j, s in enumerate(rec)  # noqa: E731
                      if s.parent == i}
    assert kids(0) == {"search.move", "play.readback"}
    move_at = names.index("search.move")
    assert kids(move_at) == MOVE_PARTS
    root = [j for j, s in enumerate(rec) if s.name == "search.root"]
    assert [rec[j].name for j, s in enumerate(rec)
            if s.parent in root] == ["model.forward"]   # the root alone
    assert [s.n for s in rec if s.name == "search.sims"] == [S - 1]
    # each span is an event of the profiler under its parent's event, of
    # about its duration: the best of three moves, since a pause of the
    # host between a span's clock and the profiler's lands in one of them
    bad = _duration_misfits(rec, events)
    for _ in range(2):
        if not bad:
            break
        gc.disable()
        try:
            _, rec, events = _profiled(move)
        finally:
            gc.enable()
        bad = _duration_misfits(rec, events)
    assert not bad, bad


def test_totals_sum_counts_durations_self_time_and_n(monkeypatch):
    rec = [profiling.Span("a", 0, 10_000, -1, 0, 0),
           profiling.Span("b", 1_000, 4_000, 0, 0, 3),
           profiling.Span("b", 5_000, 9_000, 0, 0, 4),
           profiling.Span("c", 20_000, None, -1, 3, 1)]   # still open
    monkeypatch.setattr(profiling, "_record", rec)
    t = totals()
    assert set(t) == {"a", "b"}
    assert t["a"] == (1, pytest.approx(10e-6), pytest.approx(3e-6), 0)
    assert t["b"] == (2, pytest.approx(7e-6), pytest.approx(7e-6), 7)


def test_vit_selfplay_step_records_a_forward_per_simulation():
    S, B = 5, 3
    env = make_env("gomoku")
    ref = tcfg.preset("gomoku7-reference")
    model = build_model(dataclasses.replace(ref.model, embed_dim=16,
                                            num_heads=4, depth=1), env)
    params = init_params(model, torch.Generator().manual_seed(0))
    cfg = dataclasses.replace(ref.mcts, num_simulations=S)

    def step():
        sp = init_selfplay(env, B, 2, device="cpu")
        return selfplay_step(env, make_eval_fn(model, params), cfg, sp,
                             create(env, 49 * 4, device="cpu"))

    (sp, buf), rec, _ = _profiled(step)
    names = [s.name for s in rec]
    assert names.count("model.forward") == S
    assert names[0] == "selfplay.step"
    assert {rec[j].name for j, s in enumerate(rec) if s.parent == 0} == {
        "search.move", "replay.write"}
    sp2, buf2 = step()
    for f in dataclasses.fields(sp):
        a, b = getattr(sp, f.name), getattr(sp2, f.name)
        if torch.is_tensor(a):
            assert torch.equal(a, b), f.name
    assert torch.equal(buf.obs, buf2.obs)


def test_dense_chunk_records_a_search_a_move_and_same_bits():
    M, B = 4, 3
    env = make_env("connect4")
    cfg = tcfg.MCTSConfig(num_simulations=6, dirichlet_alpha=0.3,
                          temperature_moves=2)
    rcfg = tcfg.ReplayConfig(capacity=42 * 8)

    def chunk():
        sp = init_selfplay(env, B, 5, device="cpu")
        return selfplay_chunk(env, None, None, cfg, rcfg, sp,
                              create(env, rcfg.capacity, device="cpu"), M,
                              evaluator=exact_stub_evaluator(env))

    (sp, buf), rec, _ = _profiled(chunk)
    names = [s.name for s in rec]
    assert names.count("search.move") == M
    assert names.count("search.sims") == M
    assert sum(s.n for s in rec if s.name == "search.sims") == M * 5
    assert names[0] == "selfplay.chunk" and "replay.write" in names
    sp2, buf2 = chunk()
    assert torch.equal(sp.traj_policy, sp2.traj_policy)
    assert torch.equal(sp.env_state.board, sp2.env_state.board)
    assert torch.equal(buf.policy, buf2.policy)


@pytest.mark.parametrize("family", ["dense", "resnet"])
def test_search_gives_the_same_visits_with_the_profiler(family):
    env = make_env("connect4")
    model = build_model(tcfg.ModelConfig(family=family, width=64, channels=8,
                                         blocks=1), env)
    params = init_params(model, torch.Generator().manual_seed(4))
    from alphazero_tpu_torch.search.mcts import run_mcts
    s = env.init(4)
    s = env.step(s, torch.tensor([0, 1, 2, 3], dtype=torch.int32))
    cfg = tcfg.MCTSConfig(num_simulations=8, dirichlet_alpha=0.3)

    def search():
        return run_mcts(env, make_eval_fn(model, params), s.board,
                        s.current_player, s.move_count, s.done, cfg,
                        generator=torch.Generator().manual_seed(9),
                        device="cpu")
    got, rec, _ = _profiled(search)
    want = search()
    assert "search.sims" in {r.name for r in rec}
    assert torch.equal(got.visit_counts, want.visit_counts)
    assert torch.equal(got.root_q, want.root_q)

