"""The search's CUDA graph cache (``search.fused.MoveGraphs``) on the CPU.

* A CPU move search never captures and gives exactly what
  ``move_search_reference`` gives.
* The cache's rule (capture at a key's ``CAPTURE_AT``-th search, a count
  per key, at most ``MAX_GRAPHS`` keys, never with an ``evaluator``), its
  counters and its ``search.graph`` spans, and that its fixed addresses
  leave earlier results and the weights of each call alone, through a stub
  whose "graph" replays the eager simulations on the entry, so no GPU is
  needed.
* The same for the self-play chunk (``run_selfplay_chunk``), whose moves
  replay the graph of the key it shares with the move search, against
  ``selfplay_chunk_reference`` bit for bit.

The graphs themselves run on the card: ``tests/test_torch_cuda.py``.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alphazero_tpu_torch.config import MCTSConfig, ModelConfig
from alphazero_tpu_torch.envs import make_env
from alphazero_tpu_torch.models import build_model, init_params, make_eval_fn
from alphazero_tpu_torch.ops.graphs import CAPTURE_AT, MAX_GRAPHS
from alphazero_tpu_torch.search import fused
from alphazero_tpu_torch.search.stub import drawn_board
from alphazero_tpu_torch.utils import profiling

CFG = MCTSConfig(num_simulations=10, use_dirichlet=False)


class _Stub(fused.MoveGraphs):
    """Engages on the CPU; its "graph" is the eager chain, replayed, and
    its capture runs the chain once as the card's warm-up does."""

    def _engages(self, x):
        return True

    def _capture(self, fn, device):
        fn()                 # the warm-up runs on the entry, as on the card
        return fn


@pytest.fixture
def stub(monkeypatch):
    s = _Stub()
    monkeypatch.setattr(fused, "MOVE_GRAPHS", s)
    return s


def _model(width=64, seed=0, game="connect4"):
    env = make_env(game)
    model = build_model(ModelConfig(family="dense", width=width, blocks=1),
                        env)
    params = init_params(model, torch.Generator().manual_seed(seed))
    return env, model, params


def _roots(env, B, seed):
    """B roots of random legal play, each stopped at its own length (some
    finished), the last one a drawn full board."""
    g = torch.Generator().manual_seed(seed)
    st = env.init(B)
    target = torch.randint(0, 16, (B,), generator=g)
    for t in range(16):
        mask = env.valid_mask(st) & (t < target)[:, None] & ~st.done[:, None]
        act = torch.where(mask, torch.rand(mask.shape, generator=g), -1.0
                          ).argmax(-1).to(torch.int32)
        nxt = env.step(st, act)
        live = mask.any(-1)
        st = type(st)(*(torch.where(
            live.reshape((B,) + (1,) * (getattr(st, f).dim() - 1)),
            getattr(nxt, f), getattr(st, f)) for f in vars(st)))
    st.board[-1] = drawn_board(env)
    st.current_player[-1], st.move_count[-1] = 0, env.max_moves
    st.done[-1] = True
    return st.board, st.current_player, st.move_count, st.done


def _search(env, model, params, roots, cfg=CFG, **kw):
    return fused.run_mcts_fused(env, model, params,
                                make_eval_fn(model, params), *roots, cfg,
                                device="cpu", **kw)


def _want(env, model, params, roots, cfg=CFG):
    return fused.move_search_reference(env, model, params,
                                       make_eval_fn(model, params), *roots,
                                       cfg)


def _equal(got, want):
    for name in ("visit_counts", "policy", "root_q"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("formula", ["reference", "alphazero"])
def test_cpu_move_search_never_captures_and_is_the_reference(formula):
    env, model, params = _model()
    cfg = dataclasses.replace(CFG, formula=formula, c_puct=1.7)
    before = (fused.MOVE_GRAPHS.captures, fused.MOVE_GRAPHS.replays)
    for k in range(CAPTURE_AT + 2):
        roots = _roots(env, 4, k)
        _equal(_search(env, model, params, roots, cfg),
               _want(env, model, params, roots, cfg))
    assert (fused.MOVE_GRAPHS.captures, fused.MOVE_GRAPHS.replays) == before
    assert not fused.MOVE_GRAPHS._entries


def test_stub_captures_a_key_at_its_kth_search(stub):
    env, model, params = _model()
    for k in range(1, CAPTURE_AT + 3):
        roots = _roots(env, 3, k)
        _equal(_search(env, model, params, roots),
               _want(env, model, params, roots))
        assert stub.captures == int(k >= CAPTURE_AT)
        assert stub.replays == max(0, k - CAPTURE_AT + 1)


@pytest.mark.parametrize("change", ["B", "S", "c_puct", "formula", "width",
                                    "game"])
def test_stub_counts_each_key_on_its_own(stub, change):
    """Two keys that differ in one of what the launches bake in count
    apart: neither captures before its own CAPTURE_AT-th search."""
    env, model, params = _model()
    B, cfg = 2, CFG
    other = dict(env=env, model=model, params=params, B=B, cfg=cfg)
    if change == "B":
        other["B"] = 3
    elif change == "S":
        other["cfg"] = dataclasses.replace(cfg, num_simulations=12)
    elif change == "c_puct":
        other["cfg"] = dataclasses.replace(cfg, c_puct=2.0)
    elif change == "formula":
        other["cfg"] = dataclasses.replace(cfg, formula="alphazero")
    elif change == "width":
        _, other["model"], other["params"] = _model(width=128)
    else:
        other["env"], other["model"], other["params"] = _model(
            game="tictactoe")
    for k in range(CAPTURE_AT - 1):
        _search(env, model, params, _roots(env, B, k), cfg)
        o = other
        _search(o["env"], o["model"], o["params"],
                _roots(o["env"], o["B"], k), o["cfg"])
    assert stub.captures == 0
    roots = _roots(env, B, 9)
    _equal(_search(env, model, params, roots, cfg),
           _want(env, model, params, roots, cfg))
    assert (stub.captures, stub.replays) == (1, 1)
    o = other
    roots = _roots(o["env"], o["B"], 9)
    _equal(_search(o["env"], o["model"], o["params"], roots, o["cfg"]),
           _want(o["env"], o["model"], o["params"], roots, o["cfg"]))
    assert (stub.captures, stub.replays) == (2, 2)
    assert len(stub._entries) == 2


def test_stub_holds_at_most_max_graphs_keys(stub):
    env, model, params = _model()
    for B in range(1, MAX_GRAPHS + 1):
        for k in range(CAPTURE_AT):
            _search(env, model, params, _roots(env, B, k))
    assert (stub.captures, stub.replays) == (MAX_GRAPHS, MAX_GRAPHS)
    extra = MAX_GRAPHS + 1
    for k in range(CAPTURE_AT + 1):                # beyond the cap: eager
        roots = _roots(env, extra, k)
        _equal(_search(env, model, params, roots),
               _want(env, model, params, roots))
    assert (stub.captures, stub.replays) == (MAX_GRAPHS, MAX_GRAPHS)
    assert len(stub._entries) == MAX_GRAPHS
    _search(env, model, params, _roots(env, 1, 7))  # a held key replays
    assert (stub.captures, stub.replays) == (MAX_GRAPHS, MAX_GRAPHS + 1)


def test_stub_never_engages_with_an_evaluator(stub):
    env, model, params = _model()
    packed = fused.pack_dense_params(model, params)
    for k in range(CAPTURE_AT + 2):
        roots = _roots(env, 3, k)
        got = _search(env, model, params, roots,
                      evaluator=lambda o: fused.dense_forward(o, packed))
        _equal(got, _want(env, model, params, roots))
    assert (stub.captures, stub.replays) == (0, 0)
    assert not stub._calls and not stub._entries


def test_stub_spans_one_graph_span_a_replay(stub):
    """Under a profiler every replay is a ``search.graph`` span inside the
    search's ``search.sims`` span."""
    env, model, params = _model()
    calls = CAPTURE_AT + 2
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(calls):
            _search(env, model, params, _roots(env, 2, k))
    t = profiling.totals()
    assert t["search.sims"][0] == calls
    assert t["search.graph"][0] == stub.replays == calls - CAPTURE_AT + 1
    sims = {i for i, s in enumerate(profiling.spans())
            if s.name == "search.sims"}
    assert all(s.parent in sims for s in profiling.spans()
               if s.name == "search.graph")
    profiling.reset()


def test_stub_results_stay_after_the_next_search(stub):
    """Each search's result is fresh: the entry's tree and inputs, reused
    by the next search at the key, are not what the caller holds."""
    env, model, params = _model()
    kept = []
    for k in range(CAPTURE_AT + 2):
        res = _search(env, model, params, _roots(env, 3, 20 + k))
        kept.append((res, [getattr(res, n).clone() for n in
                           ("visit_counts", "policy", "root_q")]))
    assert stub.replays == 3
    for res, copy in kept:
        for name, c in zip(("visit_counts", "policy", "root_q"), copy):
            assert torch.equal(getattr(res, name), c)
    for (a, _), (b, _) in zip(kept, kept[1:]):
        assert a.visit_counts.data_ptr() != b.visit_counts.data_ptr()


def test_stub_takes_each_calls_params(stub):
    """Two params dicts alternating at one key (the gate's two players),
    then an in-place update of one weight: every search gives its own
    weights' result."""
    env, model, p0 = _model(seed=0)
    _, _, p1 = _model(seed=1)
    roots = _roots(env, 3, 5)
    for k in range(2 * CAPTURE_AT):
        params = (p0, p1)[k % 2]
        _equal(_search(env, model, params, roots),
               _want(env, model, params, roots))
    assert stub.captures == 1 and stub.replays == 2 * CAPTURE_AT - 2
    a, b = (_search(env, model, p, roots) for p in (p0, p1))
    assert not torch.equal(a.policy, b.policy)
    with torch.no_grad():
        p0["block_0.fc1.weight"].mul_(-1.5)
    got = _search(env, model, p0, roots)
    _equal(got, _want(env, model, p0, roots))
    assert not torch.equal(got.policy, a.policy)


# ---------------------------------------------------------------------------
# the self-play chunk on the cache
# ---------------------------------------------------------------------------

M = 3
CHUNK = ("obs", "policy", "player", "t", "action", "done", "winner",
         "root_q", "board", "player_final", "mc_final")


def _chunk_inputs(env, B, seed):
    """Chunk roots of random play (finished games reset, as the collector
    hands them in) and the chunk's noise and uniforms."""
    board, player, mc, done = _roots(env, B, seed)
    board = torch.where(done[:, None, None, None], 0, board)
    player = torch.where(done, 0, player).to(torch.int32)
    mc = torch.where(done, 0, mc).to(torch.int32)
    g = torch.Generator().manual_seed(1000 + seed)
    noise = fused.dirichlet_noise(M, env.action_dim, B, 0.3, g,
                                  torch.device("cpu"))
    unif = torch.rand((M, B), generator=g)
    return (board, player, mc), dict(noise=noise, unif=unif)


def _chunk(env, model, params, roots, draws, cfg=CFG, **kw):
    return fused.run_selfplay_chunk(env, model, params, *roots, cfg, M,
                                    device="cpu", **draws, **kw)


def _chunk_want(env, model, params, roots, draws, cfg=CFG):
    return fused.selfplay_chunk_reference(env, model, params, *roots, cfg, M,
                                          **draws)


def _same_chunk(got, want):
    assert set(got) == set(CHUNK)
    for name in CHUNK:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("dirichlet,formula", [(False, "reference"),
                                               (True, "reference"),
                                               (False, "alphazero"),
                                               (True, "alphazero")])
def test_stub_chunk_replays_every_move_from_its_kth_call(stub, dirichlet,
                                                         formula):
    """Every chunk of a run at one key, the eager ones, the capture's and
    the replays', gives the plain chunk's records and final state bit for
    bit; the key's CAPTURE_AT-th call captures, and each call from then
    on replays the graph once a move."""
    env, model, params = _model()
    cfg = dataclasses.replace(CFG, use_dirichlet=dirichlet, formula=formula,
                              c_puct=1.7, temperature_moves=2)
    for k in range(1, CAPTURE_AT + 3):
        roots, draws = _chunk_inputs(env, 4, k)
        _same_chunk(_chunk(env, model, params, roots, draws, cfg),
                    _chunk_want(env, model, params, roots, draws, cfg))
        assert stub.captures == int(k >= CAPTURE_AT)
        assert stub.replays == M * max(0, k - CAPTURE_AT + 1)


def test_stub_chunk_and_move_search_share_a_key(stub):
    """A chunk and a move search of one shape count together towards
    CAPTURE_AT and share the entry: the search captures at the key's
    CAPTURE_AT-th call, and the next chunk replays that graph."""
    env, model, params = _model()
    B = 4
    for k in range(CAPTURE_AT - 1):
        roots, draws = _chunk_inputs(env, B, k)
        _same_chunk(_chunk(env, model, params, roots, draws),
                    _chunk_want(env, model, params, roots, draws))
    assert (stub.captures, stub.replays) == (0, 0)
    roots = _roots(env, B, 9)
    _equal(_search(env, model, params, roots),
           _want(env, model, params, roots))
    assert (stub.captures, stub.replays) == (1, 1)
    roots, draws = _chunk_inputs(env, B, 10)
    _same_chunk(_chunk(env, model, params, roots, draws),
                _chunk_want(env, model, params, roots, draws))
    assert (stub.captures, stub.replays) == (1, 1 + M)
    assert len(stub._entries) == 1 and list(stub._calls.values()) == [
        CAPTURE_AT]


def test_stub_chunk_never_engages_with_an_evaluator(stub):
    env, model, params = _model()
    packed = fused.pack_dense_params(model, params)
    for k in range(CAPTURE_AT + 2):
        roots, draws = _chunk_inputs(env, 3, k)
        got = _chunk(env, model, params, roots, draws,
                     evaluator=lambda o: fused.dense_forward(o, packed))
        _same_chunk(got, _chunk_want(env, model, params, roots, draws))
    assert (stub.captures, stub.replays) == (0, 0)
    assert not stub._calls and not stub._entries


def test_stub_chunk_results_and_inputs_stay_after_the_next_call(stub):
    """Each chunk's records and final state are fresh, and its inputs are
    left as they were: the entry's board, player, move counts and tree,
    reused by the next call at the key, are not what the caller holds."""
    env, model, params = _model()
    kept, held = [], []
    for k in range(CAPTURE_AT + 2):
        roots, draws = _chunk_inputs(env, 3, 20 + k)
        copies = tuple(r.clone() for r in roots)
        res = _chunk(env, model, params, roots, draws)
        kept.append((res, {n: res[n].clone() for n in CHUNK}))
        held.append((roots, copies))
    assert stub.replays == 3 * M
    for res, copy in kept:
        for name in CHUNK:
            assert torch.equal(res[name], copy[name]), name
    for roots, copies in held:
        assert all(torch.equal(r, c) for r, c in zip(roots, copies))
    for (a, _), (b, _) in zip(kept, kept[1:]):
        assert a["board"].data_ptr() != b["board"].data_ptr()


def test_stub_chunk_takes_each_calls_params(stub):
    """Two params dicts alternating at one key, then an in-place update of
    one weight (the learner's step between two collects): every chunk
    gives its own weights' records."""
    env, model, p0 = _model(seed=0)
    _, _, p1 = _model(seed=1)
    roots, draws = _chunk_inputs(env, 3, 5)
    for k in range(2 * CAPTURE_AT):
        params = (p0, p1)[k % 2]
        _same_chunk(_chunk(env, model, params, roots, draws),
                    _chunk_want(env, model, params, roots, draws))
    assert stub.captures == 1 and stub.replays == M * (2 * CAPTURE_AT - 2)
    before = _chunk(env, model, p0, roots, draws)
    with torch.no_grad():
        p0["block_0.fc1.weight"].mul_(-1.5)
    got = _chunk(env, model, p0, roots, draws)
    _same_chunk(got, _chunk_want(env, model, p0, roots, draws))
    assert not torch.equal(got["root_q"], before["root_q"])


def test_stub_chunk_spans_one_graph_span_a_move(stub):
    """Under a profiler every move of a replaying chunk is one
    ``search.graph`` span inside that move's ``search.sims`` span."""
    env, model, params = _model()
    calls = CAPTURE_AT + 1
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(calls):
            _chunk(env, model, params, *_chunk_inputs(env, 2, k))
    t = profiling.totals()
    assert t["search.sims"][0] == calls * M
    assert t["search.graph"][0] == stub.replays == 2 * M
    sims = {i for i, s in enumerate(profiling.spans())
            if s.name == "search.sims"}
    assert all(s.parent in sims for s in profiling.spans()
               if s.name == "search.graph")
    profiling.reset()
