"""The result line: its keys, the metrics a cell reports, the trace's
breakdown, and no result without a card."""

import json
import shutil
import subprocess
import sys

import pytest

from mmbench import harness
from mmbench_runs import CELL, ROOT, cpu_run


def test_result_keys():
    res = cpu_run()
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {n for n, _ in harness.metric_names(bench, CELL, False)}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for check in res["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(res)


def test_traced_result_has_the_window_and_breakdown():
    res = cpu_run(trace=True)
    assert list(res)[-1] == "checks" and "breakdown" in res
    assert res["device"]["window_s"] > 0
    assert res["breakdown"]["idle_gaps"]
    assert len(res["breakdown"]["device_ops"]) <= 10
    # No device operations run on the CPU: the roofline readers find
    # nothing to read and leave their metrics out.
    assert "sinkhorn_roofline" not in res["metrics"]
    assert res["metrics"]["snapshot_ms"]["value"] > 0


def run_cli(cwd, *args):
    return subprocess.run(
        [sys.executable, "mmbench/run.py", "--workload", CELL, "--seed",
         "5", "--seconds", "1", *args], cwd=cwd, capture_output=True,
        text=True, timeout=300)


def test_no_result_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = run_cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "mmbench", tmp_path / "mmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
