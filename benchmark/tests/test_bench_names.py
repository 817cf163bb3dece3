"""BENCHMARK.json keeps to the benchmark's contract: its keys, names,
units and files."""

import json
import re

import pytest

from benchmark.run import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


def _names():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            yield kind, entry


@pytest.mark.parametrize(("kind", "entry"), list(_names()), ids=lambda x: x if isinstance(x, str) else x["name"])
def test_names_units_and_lines(kind, entry):
    keys = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
    }[kind]
    assert set(entry) <= keys and NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert LINE.match(entry[key]), (key, entry[key])
    if kind in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    if kind == "configs":
        assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
        assert (ROOT / entry["file"]).is_file() and entry["file"].startswith("benchmark/")
    if kind == "workloads":
        assert entry["chips"] == 1 and NAME.match(entry["config"]) and NAME.match(entry["traffic"])


def test_every_name_has_its_file():
    here = ROOT / "benchmark"
    for w in BENCH["workloads"]:
        assert (here / "traffic" / f"{w['traffic']}.json").is_file()
        assert (here / "limits" / f"{w['name']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (here / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_metrics_cells_and_bounds():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        assert sum(cell in m.get("workloads", cells) for m in BENCH["end_to_end"]) >= 2
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and any("mfu" in n for n in names)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_file_a_cell_names_loads(workload):
    """The cell's traffic, limits, entry, arrival process, judge and each
    metric's reader load, and the traced run's readers can install their
    spans on the program."""
    from benchmark.run import Cell, Context, load_plugin
    from benchmark.spans import Spans

    cell = Cell.load(ROOT / "BENCHMARK.json", workload)
    entry = load_plugin("entries", cell.traffic["entry"])
    assert callable(entry.make) and entry.BATCH.startswith("raglite_tpu_torch.")
    assert callable(load_plugin("arrivals", cell.traffic["arrivals"]).make)
    assert callable(load_plugin("judges", entry.ANSWER).judge)
    spans = Spans()
    ctx = Context(cell, (0.0, 1.0), [], {}, spans, 1, entry=entry)
    try:
        for metric in cell.end_to_end + cell.per_layer:
            reader = load_plugin("metrics", metric["name"])
            assert callable(reader.read), metric["name"]
            if metric in cell.per_layer and hasattr(reader, "install"):
                reader.install(ctx)
    finally:
        spans.restore()
