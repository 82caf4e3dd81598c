"""``sims_graph_share.play`` from handmade span totals: the share of
``search.sims`` spans that replayed the move search's graph, and None where
nothing was recorded, no search replayed one, or the program has no
recorder."""

import pytest

from azbench import spec
from alphazero_tpu_torch.utils import profiling

NAME = "sims_graph_share.play"


@pytest.mark.parametrize("totals,want", [
    ({"search.sims": (20, 0.001, 0.0005, 3980),
      "search.graph": (20, 0.0005, 0.0005, 0)}, 100.0),
    ({"search.sims": (8, 0.2, 0.15, 1592),
      "search.graph": (6, 0.0003, 0.0003, 0)}, 75.0),
])
def test_share_from_handmade_totals(totals, want, monkeypatch):
    monkeypatch.setattr(profiling, "totals", lambda: dict(totals))
    assert spec.reader(NAME)(None) == pytest.approx(want)


@pytest.mark.parametrize("totals", [
    {},
    {"search.graph": (3, 0.001, 0.001, 0)},
    {"search.sims": (20, 0.6, 0.6, 3980)},        # a parent with no graphs
])
def test_share_of_nothing_recorded_is_none(totals, monkeypatch):
    monkeypatch.setattr(profiling, "totals", lambda: dict(totals))
    assert spec.reader(NAME)(None) is None


def test_share_of_a_program_without_spans_is_none(monkeypatch):
    monkeypatch.delattr(profiling, "totals")
    assert spec.reader(NAME)(None) is None


def test_share_is_read_in_the_play_cell_alone():
    for cell in ("connect4.selfplay", "gomoku7-reference.selfplay",
                 "connect4.play"):
        names = {m["name"]: m for m in spec.load_cell(cell).per_layer}
        assert (NAME in names) == (cell == "connect4.play")
    m = names[NAME]
    assert (m["source"], m["layer"], m["moves"]) == (
        "program_span", "search host loop", "move_ms_p95")
