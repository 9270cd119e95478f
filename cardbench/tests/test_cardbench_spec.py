"""BENCHMARK.json against the benchmark's contract, and every cell, mix,
configuration, limit and reader found by name."""
from __future__ import annotations

import json
import re

import pytest

from cardbench_util import LATER, ROOT, cell
from cardbench.harness import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_command_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "cardbench/run.py"]
    assert BENCH["paths"] == ["cardbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("cardbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in METRICS:
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound",
                                          "source", "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS + sorted(LATER))
def test_cell_resolves_from_its_files(name):
    c = cell(name)
    assert c.config["family"] and c.traffic["solver"]
    assert set(c.limits) == {"energy_mismatch_share", "best_energy_gap"}
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert any(e["name"] == m["moves"] for e in c.end_to_end)
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]).read)
    assert callable(spec.family(c.config["family"]).make)
    assert callable(spec.reference(c.traffic["solver"]).answers)


def test_every_config_is_used_and_reduced_is_empty():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] == []


def test_later_cells_stand_apart_and_would_fit():
    assert not set(LATER) & set(CELLS)
    for name, more in LATER.items():
        assert [w["name"] for w in more["workloads"]] == [name]
        for m in more["end_to_end"] + more["per_layer"]:
            assert m["workloads"] == [name] and NAME.match(m["name"])
        for c in more["configs"]:
            assert (ROOT / c["file"]).exists()


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
    for name in LATER:                  # the check never runs them
        with pytest.raises(KeyError):
            spec.cell(name)


@pytest.mark.parametrize("lookup", [spec.family, spec.reference,
                                    spec.reader])
def test_unknown_files_are_refused(lookup):
    with pytest.raises(KeyError, match="missing"):
        lookup("no-such-name")
