"""The eager evaluator of ``models.make_eval_fn`` on the CPU.

* On CPU tensors it never captures a graph and returns exactly what the
  eager forward returns (``functional_call`` and a softmax), for every
  family; the dense family keeps its ``dense_spec``.
* Its shape-cache rule (capture at the ``CAPTURE_AT``-th call of a shape,
  at most ``MAX_GRAPHS`` shapes, never for a model that runs collectives)
  and its counters and spans, through a stub whose "graph" replays the
  eager forward, so no GPU is needed.

The graphs themselves run on the card: ``tests/test_torch_cuda.py``.
"""

import pytest
import torch
from torch.func import functional_call
from torch.profiler import ProfilerActivity, profile

from alphazero_tpu_torch.config import ModelConfig
from alphazero_tpu_torch.envs import make_env
from alphazero_tpu_torch.models import (Evaluator, build_model, init_params,
                                        make_eval_fn)
from alphazero_tpu_torch.ops.graphs import CAPTURE_AT, MAX_GRAPHS
from alphazero_tpu_torch.parallel import TPViT
from alphazero_tpu_torch.utils import profiling

MODELS = {
    "vit": ("gomoku", ModelConfig(family="vit", embed_dim=32, num_heads=4,
                                  patch_size=3, depth=1)),
    "dense": ("connect4", ModelConfig(family="dense", width=64, blocks=1)),
    "resnet": ("tictactoe", ModelConfig(family="resnet", channels=16,
                                        blocks=1)),
    "resnet_bn": ("tictactoe", ModelConfig(family="resnet_bn", channels=16,
                                           blocks=1)),
}


def _model(family):
    env_name, mcfg = MODELS[family]
    env = make_env(env_name)
    model = build_model(mcfg, env)
    params = init_params(model, torch.Generator().manual_seed(0))
    return env, model, params


def _obs(env, B, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((B, env.feature_dim, env.rows, env.cols),
                       generator=g) < 0.3).float()


def _eager(model, params, obs):
    with torch.no_grad():
        logits, value = functional_call(model, params, (obs,))
    return torch.softmax(logits, dim=-1), value


class _Stub(Evaluator):
    """Engages on the CPU; its "graph" is the eager forward, replayed."""

    def _engages(self, x):
        return True

    def _capture(self, fn, device):
        fn()                 # the warm-up, as on the card
        return fn


@pytest.mark.parametrize("family", sorted(MODELS))
def test_cpu_evaluator_never_captures_and_is_the_eager_forward(family):
    env, model, params = _model(family)
    ev = make_eval_fn(model, params)
    assert isinstance(ev, Evaluator)
    for k in range(CAPTURE_AT + 2):
        obs = _obs(env, 5, k)
        probs, value = ev(obs)
        want_p, want_v = _eager(model, params, obs)
        assert torch.equal(probs, want_p) and torch.equal(value, want_v)
    assert (ev.captures, ev.replays) == (0, 0)
    assert hasattr(ev, "dense_spec") == (family == "dense")
    if family == "dense":
        assert ev.dense_spec == (model, params)


def test_stub_captures_a_shape_at_its_kth_call():
    env, model, params = _model("vit")
    ev = _Stub(model, params)
    for k in range(1, CAPTURE_AT + 3):
        obs = _obs(env, 4, k)
        probs, value = ev(obs)
        want_p, want_v = _eager(model, params, obs)
        assert torch.equal(probs, want_p) and torch.equal(value, want_v)
        assert ev.captures == int(k >= CAPTURE_AT)
        assert ev.replays == max(0, k - CAPTURE_AT + 1)


def test_stub_counts_each_shape_on_its_own():
    env, model, params = _model("dense")
    ev = _Stub(model, params)
    for _ in range(CAPTURE_AT - 1):
        ev(_obs(env, 2, 0))
        ev(_obs(env, 3, 0))
    assert ev.captures == 0
    ev(_obs(env, 2, 1))
    assert (ev.captures, ev.replays) == (1, 1)
    ev(_obs(env, 3, 1))
    assert (ev.captures, ev.replays) == (2, 2)


def test_stub_holds_at_most_max_graphs_shapes():
    env, model, params = _model("dense")
    ev = _Stub(model, params)
    for B in range(1, MAX_GRAPHS + 1):
        for _ in range(CAPTURE_AT):
            ev(_obs(env, B, B))
    assert (ev.captures, ev.replays) == (MAX_GRAPHS, MAX_GRAPHS)
    extra = MAX_GRAPHS + 1
    for k in range(CAPTURE_AT + 2):                # beyond the cap: eager
        obs = _obs(env, extra, k)
        probs, _ = ev(obs)
        assert torch.equal(probs, _eager(model, params, obs)[0])
    assert (ev.captures, ev.replays) == (MAX_GRAPHS, MAX_GRAPHS)
    ev(_obs(env, 1, 9))                             # a cached shape replays
    assert (ev.captures, ev.replays) == (MAX_GRAPHS, MAX_GRAPHS + 1)


def test_a_model_that_runs_collectives_is_never_captured():
    assert TPViT.runs_collectives
    env, model, params = _model("vit")
    model.runs_collectives = True
    ev = _Stub(model, params)
    assert not ev.graphable
    for k in range(CAPTURE_AT + 3):
        ev(_obs(env, 4, k))
    assert (ev.captures, ev.replays) == (0, 0)


def test_stub_spans_one_graph_span_a_replay():
    """Under a profiler every call is a ``model.forward`` span and every
    replay a ``model.graph`` span inside it."""
    env, model, params = _model("vit")
    ev = _Stub(model, params)
    calls = CAPTURE_AT + 4
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(calls):
            ev(_obs(env, 3, k))
    t = profiling.totals()
    assert t["model.forward"][0] == calls
    assert t["model.graph"][0] == ev.replays == calls - CAPTURE_AT + 1
    forwards = {i for i, s in enumerate(profiling.spans())
                if s.name == "model.forward"}
    assert all(s.parent in forwards for s in profiling.spans()
               if s.name == "model.graph")
    profiling.reset()


def test_forward_span_carries_the_rows():
    """Each ``model.forward`` span, eager, capturing or replayed, carries
    its call's rows as ``n``, the count ``forward_roofline.selfplay``
    reads."""
    env, model, params = _model("resnet_bn")
    ev = _Stub(model, params)
    rows = [3, 5, 3, 3, 3]
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for k, B in enumerate(rows):
            ev(_obs(env, B, k))
    t = profiling.totals()
    assert ev.replays == 2
    assert t["model.forward"][0] == len(rows)
    assert t["model.forward"][3] == sum(rows)
    profiling.reset()
