"""BENCHMARK.json against the contract's shape: names and units of the
allowed characters, files found by name, and every per-layer metric's
``moves`` reported in each of its cells."""

from __future__ import annotations

import re

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_names_units_and_files():
    m = harness.manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    metrics = m["end_to_end"] + m["per_layer"]
    names = [x["name"] for x in metrics] + [w["name"] for w in m["workloads"]] + [c["name"] for c in m["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in m["workloads"]]:
        assert NAME.match(n), n
    for x in metrics:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher"), x
        assert (harness.HERE / "metrics" / f"{x['name']}.py").exists(), x["name"]
    for x in m["end_to_end"]:
        assert 0 < x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])
    for w in m["workloads"]:
        c = harness.cell(w["name"], m)
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert set(c["cell_file"]["limits"]) and c["cell_file"]["trace_calls"] > 0


def test_moves_reported_in_each_cell():
    m = harness.manifest()
    for w in m["workloads"]:
        e2e = {x["name"] for x in harness.metrics_of(w["name"], m, trace=False)}
        layer = harness.metrics_of(w["name"], m, trace=True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]
        for x in layer:
            assert x["moves"] in e2e, (w["name"], x["name"])
    for x in m["per_layer"]:
        for cell in x.get("workloads", []):
            assert x["moves"] in {y["name"] for y in harness.metrics_of(cell, m, trace=False)}
