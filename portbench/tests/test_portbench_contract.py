"""BENCHMARK.json against the benchmark's contract, and every cell loaded
from its files alone."""

import json
import math
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(CELLS)) == len(CELLS)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in CELLS:
        own = [m for m in BENCH["end_to_end"]
               if cell in m.get("workloads", CELLS)]
        assert len(own) >= 2
        layers = [m for m in BENCH["per_layer"] if cell in m["workloads"]]
        assert layers
        for m in layers:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)


def test_run_seconds_fit_the_check_with_every_cell():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_per_layer_readers_match_their_entries():
    for m in BENCH["per_layer"]:
        reader = harness.metric_reader(m["name"])
        assert reader.NAME == m["name"]
        assert reader.UNIT == m["unit"]
        assert reader.LAYER == m["layer"]
        assert reader.MOVES == m["moves"]
        assert reader.SOURCE == m["source"]
        assert reader.read({}) is None  # nothing to read, nothing returned


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_loads_from_its_files_alone(cell):
    bench, spec, config, traffic, limits = harness.cell_parts(cell)
    entry = {c["name"]: c for c in bench["configs"]}[spec["config"]]
    assert config["name"] == spec["config"]
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert (ROOT / "portbench" / "drivers"
            / f"{traffic['driver']}.py").is_file()
    assert limits and all(v >= 0 for v in limits.values())
    for path in (entry["file"], f"portbench/traffic/{spec['traffic']}.json",
                 f"portbench/workloads/{cell}.json"):
        assert (ROOT / path).is_file()
        assert path.startswith("portbench/")


def test_seeds_take_any_whole_number():
    big = harness.Seeds.of(2**33 + 5)
    assert big == harness.Seeds.of(2**33 + 5)
    assert big != harness.Seeds.of(2**33 + 6)
    assert all(0 <= s < 2**31 for s in vars(big).values())
    assert math.isfinite(harness.Seeds.of(0).env)
