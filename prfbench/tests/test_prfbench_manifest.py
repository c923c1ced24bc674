"""BENCHMARK.json against the benchmark's contract, and every cell found by name."""
import json
import math
import re

import pytest

from prfbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in MAN["workloads"]]
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|"
                   r"experts_per_token|features|columns")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (harness.ROOT / p).is_dir()
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert cmd[1].startswith(MAN["paths"][0] + "/")
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_check_fits_the_drivers_budget_at_24_cells():
    rs = MAN["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))
    assert len({c["name"] for c in MAN["configs"]}) == len(MAN["configs"])
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(CELLS)
    assert any(m["name"] == "setup_s" and "workloads" not in m and m["bound"] <= 0.25
               for m in MAN["end_to_end"])


def test_configs_hold_the_configuration_as_run():
    files = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(MAN["paths"][0] + "/") and c["file"] not in files
        files.add(c["file"])
        cfg = harness.read_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and not WIDTH.search(key)
        assert any(w["config"] == c["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_found_by_name(name):
    c = harness.cell(MAN, name)
    entry = next(w for w in MAN["workloads"] if w["name"] == name)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["traffic"]) and entry["chips"] in (1, 4) and _line(entry["why"])
    assert (harness.HERE / "kinds" / f"{c.kind}.py").is_file()
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_every_metric_moves_one_reported_metric_in_its_cells():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS)
        mod = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py", "metric")
        assert callable(mod.read)
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, math.floor(len(CELLS) / 4))
