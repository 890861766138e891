"""Every cell of BENCHMARK.json is built from its files alone, and the file
keeps the benchmark contract's shapes."""
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(harness.ROOT)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_configs_are_used_and_files_exist():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used and NAME.match(c["name"])
        assert c["file"].startswith("portbench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] == []
        assert conf["source"] == c["source"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_builds_from_its_files(name):
    cell = harness.cell(name)
    assert cell.chips == 1
    assert cell.traffic["module"].startswith(harness.PORT + ".cli.")
    assert cell.traffic["cli"] in cell.config["cli_args"]
    assert harness.reference_module(cell).init_shapes_of(cell.config)
    judge, adapter = harness.judge_of(cell)
    assert callable(judge.judge) and hasattr(adapter, "R")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and cell.traffic["rate_metric"] in e2e
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        mod = harness.metric_module(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"],
                                                    m["moves"])
        assert callable(mod.read)
    names = judge.NAMES
    assert set(cell.limits) >= set(names), "every compared number has a limit"
    assert all(cell.limits[n]["limit"] >= 0 for n in names)


def test_argv_fills_the_traffic():
    cell = harness.cell(CELLS[0])

    class T:
        root, split = "/d", "/s"
    argv = harness.cli_argv(cell, T, "/w.pt", "/o", "cuda")
    assert "--data_path" in argv and argv[argv.index("--data_path") + 1] \
        == "/d"
    assert "{" not in " ".join(argv)
