"""``forward_roofline.selfplay`` from a synthetic trace and handmade span
totals: the forward FLOPs of the rows the ``model.forward`` spans carry
over the device time less the search's kernels, at the bf16 peak; None
where nothing was recorded."""

import pytest
import torch

from alphazero_tpu_torch.utils import profiling
from azbench import counts, spec
from azbench.harness import Run
from azbench.trace import Trace

CELL = "gomoku15-alphazero.selfplay-deep"
NAME = "forward_roofline.selfplay"
ROWS = 256 * 800


def _run(profile) -> Run:
    r = Run(cell=spec.load_cell(CELL), seed=1, seconds=0.0, trace=True,
            device=torch.device("cpu"))
    r.profile = profile
    return r


def _trace(busy_s=3.0, search_s=0.25) -> Trace:
    kernels = {"sm90_xmma_fprop_implicit_gemm_bf16": (19_000, 2.5),
               "void az::sim_step_kernel<5, 32>(...)": (800, search_s * 0.8),
               "void az::sim_flush_kernel<5, 32>(...)": (1, search_s * 0.2),
               "elementwise_kernel": (9_000, 0.25)}
    return Trace(window_s=busy_s / 0.97, busy_s=busy_s, kernels=kernels,
                 gaps=[])


def _totals(n=ROWS, calls=800):
    return {"model.forward": (calls, 1.0, 1.0, n),
            "search.sims": (1, 3.0, 2.0, 799)}


def test_the_value_follows_the_formula(monkeypatch):
    monkeypatch.setattr(profiling, "totals", lambda: _totals())
    r = _run(_trace())
    flops = counts.model_flops_per_pos(r.model, r.game) * ROWS
    want = 100.0 * flops / ((3.0 - 0.25) * counts.PEAK_BF16)
    assert spec.reader(NAME)(r) == pytest.approx(want)
    assert 0 < want < 100


def test_the_search_kernels_are_left_out(monkeypatch):
    """More search time under the same busy time reads higher: only the
    rest is the forward's."""
    monkeypatch.setattr(profiling, "totals", lambda: _totals())
    read = spec.reader(NAME)
    low, high = read(_run(_trace(search_s=0.0))), read(_run(_trace()))
    assert high == pytest.approx(low * 3.0 / 2.75)


@pytest.mark.parametrize("case", ["no trace", "no span", "no rows",
                                  "no recorder"])
def test_nothing_recorded_reads_none(case, monkeypatch):
    totals = {"no trace": _totals(), "no span": {"search.sims": (1, 1.0,
                                                                 1.0, 9)},
              "no rows": _totals(n=0), "no recorder": None}[case]
    if totals is None:
        monkeypatch.delattr(profiling, "totals")   # a program without spans
    else:
        monkeypatch.setattr(profiling, "totals", lambda: dict(totals))
    r = _run(None if case == "no trace" else _trace())
    assert spec.reader(NAME)(r) is None


def test_the_cell_lists_the_metric():
    per = {m["name"]: m for m in spec.load_cell(CELL).per_layer}
    assert per[NAME]["source"] == "device_trace"
    assert per[NAME]["moves"] == "selfplay_env_steps_per_s"
