"""``forward_graph_share.selfplay`` from handmade span totals: the share
of ``model.forward`` calls that replayed a graph, and None where nothing
was recorded, no call replayed one, or the program has no recorder."""

import pytest

from azbench import spec
from alphazero_tpu_torch.utils import profiling

NAME = "forward_graph_share.selfplay"


@pytest.mark.parametrize("totals,want", [
    ({"model.forward": (800, 0.05, 0.01, 0),
      "model.graph": (798, 0.04, 0.04, 0)}, 99.75),
    ({"model.forward": (4, 0.01, 0.01, 0),
      "model.graph": (4, 0.001, 0.001, 0)}, 100.0),
])
def test_share_from_handmade_totals(totals, want, monkeypatch):
    monkeypatch.setattr(profiling, "totals", lambda: dict(totals))
    assert spec.reader(NAME)(None) == pytest.approx(want)


@pytest.mark.parametrize("totals", [
    {},
    {"model.graph": (3, 0.001, 0.001, 0)},
    {"model.forward": (800, 0.05, 0.05, 0)},      # a parent with no graphs
])
def test_share_of_nothing_recorded_is_none(totals, monkeypatch):
    monkeypatch.setattr(profiling, "totals", lambda: dict(totals))
    assert spec.reader(NAME)(None) is None


def test_share_of_a_program_without_spans_is_none(monkeypatch):
    monkeypatch.delattr(profiling, "totals")
    assert spec.reader(NAME)(None) is None


def test_share_is_read_in_the_vit_cell_alone():
    for cell in ("connect4.selfplay", "gomoku7-reference.selfplay",
                 "connect4.play"):
        names = {m["name"] for m in spec.load_cell(cell).per_layer}
        assert (NAME in names) == (cell == "gomoku7-reference.selfplay")
