"""BENCHMARK.json against the contract's form, and the harness as data:
every configuration, traffic mix and metric is a file found by name."""

import json
import re

import pytest

from mmbench import harness

ROOT = harness.PKG.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mmbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"]:
        for key in ("why", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200
                assert "\n" not in entry[key] and "\t" not in entry[key]


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(wl):
    bench, entry, cfg, traffic = harness.load(ROOT, wl["name"])
    assert entry["chips"] in (1, 4)
    assert traffic["driver"] == "rebalance"
    assert set(cfg["limits"]) == {"g_gap", "assign_gap", "price_gap",
                                  "overflow_gap", "count_errors"}
    e2e = harness.metric_names(bench, wl["name"], False)
    layer = harness.metric_names(bench, wl["name"], True)
    assert "setup_s" in dict(e2e) and len(e2e) >= 2 and layer


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_each_metric_has_a_reader(metric):
    assert callable(harness.reader(metric["name"]))
    if metric in BENCH["per_layer"]:
        ends = {m["name"] for m in BENCH["end_to_end"]}
        assert metric["moves"] in ends
        assert "\n" not in metric["layer"]


def test_config_files_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
