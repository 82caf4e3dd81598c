"""What ``BENCHMARK.json`` and the files beside it say about one cell.

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric is a file of its own, found by its name:

* ``azbench/configs/<config>.json``: the configuration as it is run (the
  port's ``Config`` fields under ``"config"``) and its reference notes;
* ``azbench/reference/families/<family>.py``: the plain reference network
  of a model family, named by a configuration's ``model["family"]``, with
  its parameters and its FLOPs a position (``azbench/reference/nets.py``);
* ``azbench/traffic/<traffic>.json``: the mix's parameters and the name of
  the driver (``azbench/drivers/<driver>.py``) that plays it;
* ``azbench/workloads/<cell>.json``: the cell's limits of correctness;
* ``azbench/metrics/<metric>.py``: the reader of a per-layer metric, a
  ``read(run)`` that returns a number or None; where there is none,
  ``azbench/metrics/<quantity>.py``, the name's part before its first dot,
  reads the quantity for every cell family (``idle_share.selfplay`` and
  ``idle_share.play`` share ``idle_share.py``).

So a new cell, configuration, mix or metric adds files and entries and
edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict          # the configuration file
    traffic_name: str
    traffic: dict         # the traffic file
    limits: dict          # {number: limit}
    chips: int
    end_to_end: list      # the cell's end-to-end metric entries
    per_layer: list       # the cell's per-layer metric entries


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    wl = metric.get("workloads")
    if wl is not None:
        return cell in wl
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises KeyError for a
    name it does not hold."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _applies(m, name, e2e_names)]
    return Cell(
        name=name, config_name=w["config"], config=_json(root / conf["file"]),
        traffic_name=w["traffic"],
        traffic=_json(root / "azbench" / "traffic" / f"{w['traffic']}.json"),
        limits=_json(root / "azbench" / "workloads" / f"{name}.json")
        ["limits"],
        chips=int(w["chips"]), end_to_end=e2e, per_layer=per)


def driver(cell: Cell):
    """The module that plays the cell's traffic."""
    return importlib.import_module(f"azbench.drivers.{cell.traffic['driver']}")


def reader(metric: str, root: Path = ROOT):
    """``read(run)`` of ``azbench/metrics/<metric>.py``, else of the file
    named by the metric's part before its first dot."""
    path = root / "azbench" / "metrics" / f"{metric}.py"
    if not path.exists():
        path = path.with_name(metric.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "azbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
