"""``sims_graph_share.selfplay`` from handmade span totals: the share of
the chunk's ``search.sims`` spans that replayed the search's graph, and
None where nothing was recorded, no move replayed one (the parent's
chunk), or the program has no recorder."""

import pytest

from azbench import spec
from alphazero_tpu_torch.utils import profiling

NAME = "sims_graph_share.selfplay"


@pytest.mark.parametrize("totals,want", [
    ({"search.sims": (32, 0.004, 0.002, 6368),
      "search.graph": (32, 0.002, 0.002, 0)}, 100.0),
    ({"search.sims": (64, 0.3, 0.2, 12736),
      "search.graph": (32, 0.002, 0.002, 0)}, 50.0),
])
def test_share_from_handmade_totals(totals, want, monkeypatch):
    monkeypatch.setattr(profiling, "totals", lambda: dict(totals))
    assert spec.reader(NAME)(None) == pytest.approx(want)


@pytest.mark.parametrize("totals", [
    {},
    {"search.graph": (3, 0.001, 0.001, 0)},
    {"search.sims": (32, 0.9, 0.9, 6368)},        # a parent with no graphs
])
def test_share_of_nothing_recorded_is_none(totals, monkeypatch):
    monkeypatch.setattr(profiling, "totals", lambda: dict(totals))
    assert spec.reader(NAME)(None) is None


def test_share_of_a_program_without_spans_is_none(monkeypatch):
    monkeypatch.delattr(profiling, "totals")
    assert spec.reader(NAME)(None) is None


def test_share_is_read_in_the_connect4_selfplay_cell_alone():
    for cell in ("connect4.selfplay", "gomoku7-reference.selfplay",
                 "connect4.play"):
        names = {m["name"]: m for m in spec.load_cell(cell).per_layer}
        assert (NAME in names) == (cell == "connect4.selfplay")
        if cell == "connect4.selfplay":
            m = names[NAME]
    assert (m["source"], m["layer"], m["moves"]) == (
        "program_span", "search host loop", "selfplay_env_steps_per_s")
