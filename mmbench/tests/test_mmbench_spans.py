"""The metrics read from the program's refresh spans and counters: a
traced run reports them, an untraced one none, and a program without the
spans leaves them out instead of failing."""

from types import SimpleNamespace

import pytest

from mmbench import harness
from mmbench_runs import cpu_run

SPAN_METRICS = ("rpm_read_ms", "dirty_records", "cost_device_ms",
                "gate_wait_ms", "transport_device_ms", "auction_device_ms",
                "solve_device_ms")


def test_traced_run_reports_the_span_metrics():
    res = cpu_run(trace=True)
    assert res["correct"]
    got = res["metrics"]
    assert set(SPAN_METRICS) <= set(got)
    assert got["dirty_records"]["unit"] == "count"
    assert got["dirty_records"]["value"] > 0
    assert got["rpm_read_ms"]["value"] <= got["snapshot_ms"]["value"]
    assert got["gate_wait_ms"]["value"] <= got["dispatch_ms"]["value"]
    layers = sum(got[k]["value"] for k in ("cost_device_ms",
                                           "transport_device_ms",
                                           "auction_device_ms"))
    assert 0 < layers <= got["solve_device_ms"]["value"]
    # The program's ranges are host annotations, never device work.
    assert not any(name.startswith("mm.")
                   for name, _ in res["breakdown"]["device_ops"])


def test_untraced_run_reports_none_of_them():
    res = cpu_run()
    assert not set(SPAN_METRICS) & set(res["metrics"])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_finds_nothing_in_a_program_without_spans(name):
    stats = [{"snapshot_ms": 1.0, "dispatch_ms": 2.0, "extract_ms": 1.0}]
    assert harness.reader(name)(SimpleNamespace(stats=stats)) is None
