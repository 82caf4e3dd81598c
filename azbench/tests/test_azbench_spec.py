"""A cell, a configuration, a traffic mix and a per-layer metric are
found by name from files alone; the last line has the contract's keys."""

import json
import shutil

from azbench import result, spec


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "azbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    az = tmp_path / "azbench"
    conf = json.loads((az / "configs" / "connect4.json").read_text())
    conf["name"] = "newconf"
    (az / "configs" / "newconf.json").write_text(json.dumps(conf))
    (az / "traffic" / "newmix.json").write_text(json.dumps(
        {"driver": "selfplay", "games_per_collect": 0, "warm_calls": 1,
         "profile_moves": 2, "check_moves": 2}))
    (az / "workloads" / "newconf.newmix.json").write_text(json.dumps(
        {"limits": {"records_bad": 0, "visit_tv": 0.1}}))
    (az / "metrics" / "newmetric.newmix.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "newconf", "source": "x",
                             "file": "azbench/configs/newconf.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "newconf.newmix", "config": "newconf",
                               "traffic": "newmix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "newmetric.newmix", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "x", "moves":
                               "selfplay_env_steps_per_s",
                               "workloads": ["newconf.newmix"]})
    bench["end_to_end"][0]["workloads"].append("newconf.newmix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("newconf.newmix", root=tmp_path)
    assert cell.config["name"] == "newconf"
    assert cell.traffic["check_moves"] == 2
    assert cell.limits == {"records_bad": 0, "visit_tv": 0.1}
    assert [m["name"] for m in cell.per_layer] == ["newmetric.newmix"]
    assert {m["name"] for m in cell.end_to_end} == {
        "selfplay_env_steps_per_s", "setup_s"}
    assert spec.driver(cell).__name__ == "azbench.drivers.selfplay"
    assert spec.reader("newmetric.newmix", root=tmp_path)(None) == 42.0
    # a quantity's one reader serves a new cell family's metric too
    (az / "metrics" / "newquantity.py").write_text(
        "def read(run):\n    return 7.0\n")
    assert spec.reader("newquantity.newmix", root=tmp_path)(None) == 7.0


def test_every_cell_has_its_files():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"]))


def test_last_line_keys():
    checks = {"records_bad": {"value": 0, "limit": 0}}
    plain = json.loads(result.line(True, 3, 0, {"x_s": (1.5, "s")},
                                   {"platform": "gpu"}, checks))
    assert list(plain) == ["correct", "attempted", "failed", "metrics",
                           "device", "checks"]
    assert plain["metrics"] == {"x_s": {"value": 1.5, "unit": "s"}}
    traced = json.loads(result.line(True, 3, 0, {}, {}, checks,
                                    {"device_ops": [], "idle_gaps": []}))
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert result.judge(checks)
    assert not result.judge({"v": {"value": 0.2, "limit": 0.1}})
    assert not result.judge({"v": {"value": None, "limit": 0.1}})
