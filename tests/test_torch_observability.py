"""The port's observability and edge modules against the JAX package's,
on the CPU: ``observability/`` (metrics, tracing, the flight recorder,
SLOs), ``serving/admission.py``, ``serving/rate.py``, ``serving/errors.py``
and ``utils/pool.py``.

Each test runs one seeded script through both packages, each under its
own package's ``VirtualClock`` where the module reads the clock, and holds
the outputs equal:

- ``PrometheusMetrics``' text exposition (and the same text over its HTTP
  exporter on a free port), the StatsD datagrams; the process block of
  the exposition (RSS, CPU, threads, gc) describes the test process and
  is compared by its metric names only.
- ``Tracer`` records and ``outgoing_headers``, with each tracer's ids
  renamed in order of first appearance (a tracer salts its ids with a
  random per-tracer prefix, in both packages).
- ``FlightRecorder`` dumps, ``SloTracker`` snapshots and exported gauges,
  ``AdmissionController`` decisions, ``RateTracker`` rpm,
  ``BoundedDaemonPool`` run order.
"""

import dataclasses
import socket
import threading
import types
import urllib.request

import numpy as np
import pytest

import modelmesh_tpu.observability.flightrec as ref_flightrec
import modelmesh_tpu.observability.metrics as ref_metrics
import modelmesh_tpu.observability.slo as ref_slo
import modelmesh_tpu.observability.tracing as ref_tracing
import modelmesh_tpu.serving.admission as ref_admission
import modelmesh_tpu.serving.errors as ref_errors
import modelmesh_tpu.serving.rate as ref_rate
import modelmesh_tpu.utils.clock as ref_clock
import modelmesh_tpu.utils.pool as ref_pool
import modelmesh_tpu_torch.observability.flightrec as port_flightrec
import modelmesh_tpu_torch.observability.metrics as port_metrics
import modelmesh_tpu_torch.observability.slo as port_slo
import modelmesh_tpu_torch.observability.tracing as port_tracing
import modelmesh_tpu_torch.serving.admission as port_admission
import modelmesh_tpu_torch.serving.errors as port_errors
import modelmesh_tpu_torch.serving.rate as port_rate
import modelmesh_tpu_torch.utils.clock as port_clock
import modelmesh_tpu_torch.utils.pool as port_pool

REF = types.SimpleNamespace(
    metrics=ref_metrics, tracing=ref_tracing, flightrec=ref_flightrec,
    slo=ref_slo, admission=ref_admission, rate=ref_rate, clock=ref_clock,
    pool=ref_pool, errors=ref_errors)
PORT = types.SimpleNamespace(
    metrics=port_metrics, tracing=port_tracing, flightrec=port_flightrec,
    slo=port_slo, admission=port_admission, rate=port_rate,
    clock=port_clock, pool=port_pool, errors=port_errors)
METRIC_NAMES = [m.name for m in ref_metrics.Metric]
PROCESS_PREFIXES = ("mm_process_", "mm_python_")


def _both(fn):
    """``fn(pkg)`` for the reference and the port, each under its own
    package's VirtualClock; returns (reference result, port result)."""
    out = []
    for pkg in (REF, PORT):
        with pkg.clock.installed(pkg.clock.VirtualClock()) as vc:
            out.append(fn(pkg, vc))
    return out


def _split_exposition(text: str) -> tuple:
    """(the process block's metric names, every other line)."""
    proc, rest = [], []
    for line in text.splitlines():
        name = line.split()[2] if line.startswith("#") else line.split(
            "{")[0].split()[0]
        if name.startswith(PROCESS_PREFIXES):
            proc.append(name)
        else:
            rest.append(line)
    return sorted(set(proc)), rest


def test_metric_inventory_matches_reference():
    assert [(m.name, m.metric_name, m.kind, m.help)
            for m in port_metrics.Metric] == [
        (m.name, m.metric_name, m.kind, m.help) for m in ref_metrics.Metric]
    assert port_metrics.DEFAULT_BUCKETS_MS == ref_metrics.DEFAULT_BUCKETS_MS


def _metrics_script(seed: int, steps: int = 400) -> list:
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(steps):
        name = METRIC_NAMES[int(rng.integers(0, len(METRIC_NAMES)))]
        model = ["", "m-1", "m-2", "m-3"][int(rng.integers(0, 4))]
        k = int(rng.integers(0, 10))
        if k < 4:
            ops.append(("inc", name, float(rng.integers(1, 4)), model))
        elif k < 8:
            ops.append(("observe", name,
                        float(np.round(rng.exponential(200.0), 3)), model))
        elif k == 8:
            label = ["", 'slo_class="a"', 'instance="p"'][
                int(rng.integers(0, 3))]
            ops.append(("set_gauge", name, float(rng.integers(0, 100)),
                        label))
        else:
            ops.append(("clear_gauge", name, 0.0, ""))
    return ops


def _run_metrics(mod, ops, **kw):
    m = mod.PrometheusMetrics(start_server=False, **kw)
    for op, name, value, arg in ops:
        metric = mod.Metric[name]
        if op in ("set_gauge", "clear_gauge"):
            args = (metric, value, arg) if op == "set_gauge" else (metric,)
        else:
            args = (metric, value, arg)
        getattr(m, op)(*args)
    return m


@pytest.mark.parametrize("seed,per_model,instance_id",
                         [(0, False, ""), (1, True, "i-7"), (2, True, "")])
def test_prometheus_exposition_matches_reference(seed, per_model,
                                                 instance_id):
    ops = _metrics_script(seed)
    texts = [
        _run_metrics(mod, ops, per_model=per_model,
                     instance_id=instance_id).render()
        for mod in (ref_metrics, port_metrics)
    ]
    ref, port = (_split_exposition(t) for t in texts)
    assert ref == port
    assert any("_bucket" in line for line in ref[1])
    assert "mm_process_threads" in ref[0]


def test_prometheus_exporter_serves_the_exposition():
    """Both exporters on free ports serve the same page (the process block
    aside) as the port's ``render``."""
    ops = _metrics_script(3, steps=60)
    pages = []
    for mod in (ref_metrics, port_metrics):
        m = mod.PrometheusMetrics(port=0, instance_id="i-0")
        try:
            for op, name, value, arg in ops:
                metric = mod.Metric[name]
                if op == "set_gauge":
                    m.set_gauge(metric, value, arg)
                elif op == "clear_gauge":
                    m.clear_gauge(metric)
                else:
                    getattr(m, op)(metric, value, arg)
            assert m.port > 0
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{m.port}/metrics", timeout=10) as r:
                assert r.headers["Content-Type"].startswith("text/plain")
                pages.append(r.read().decode())
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(f"http://127.0.0.1:{m.port}/other",
                                       timeout=10)
            if mod is port_metrics:
                assert (_split_exposition(pages[-1])[1]
                        == _split_exposition(m.render())[1])
        finally:
            m.close()
    assert _split_exposition(pages[0]) == _split_exposition(pages[1])


def test_statsd_datagrams_match_reference():
    ops = _metrics_script(4, steps=80)
    got = []
    for mod in (ref_metrics, port_metrics):
        sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sink.bind(("127.0.0.1", 0))
        sink.settimeout(10)
        m = mod.StatsDMetrics(port=sink.getsockname()[1], prefix="mmx")
        n = 0
        try:
            for op, name, value, arg in ops:
                if op == "clear_gauge":
                    m.clear_gauge(mod.Metric[name])
                    continue
                getattr(m, op)(mod.Metric[name], value, arg)
                n += 1
            got.append([sink.recv(4096).decode() for _ in range(n)])
        finally:
            m.close()
            sink.close()
    assert got[0] == got[1]
    assert any(p.endswith("|ms") for p in got[0])


def _renamed(records, ids: dict) -> list:
    """Trace records with each id replaced by its order of appearance."""
    def rn(v):
        if not v:
            return v
        return ids.setdefault(v, f"id{len(ids)}")

    out = []
    for r in records:
        r = dict(r)
        for key in ("trace_id", "span_id", "parent_id"):
            r[key] = rn(r[key])
        r["spans"] = [dict(s, span_id=rn(s["span_id"]),
                           parent_id=rn(s["parent_id"])) for s in r["spans"]]
        out.append(r)
    return out


def _trace_script(pkg, vc):
    tr = pkg.tracing
    metrics = pkg.metrics.PrometheusMetrics(start_server=False)
    tracer = tr.Tracer("i-1", capacity=6, metrics=metrics, sample_n=3)
    headers, ids = [], {}
    rng = np.random.default_rng(5)
    for k in range(12):
        adopted = f"up{k}" if k % 4 == 0 else ""
        with tracer.trace(adopted, f"m{k % 3}", "predict",
                          parent_span="upspan" if adopted else "") as tid:
            headers.append(tr.outgoing_headers([("a", "b")]))
            with tracer.span("route-select", candidates=k):
                vc.advance(int(rng.integers(1, 5)))
            try:
                with tracer.span("forward-hop") as attrs:
                    headers.append(tr.outgoing_headers([]))
                    headers.append((tracer.current_trace_id() == tid,
                                    tr.incoming_trace_id(headers[-1]),
                                    tr.incoming_parent_span(headers[-1])))
                    vc.advance(2)
                    attrs["chunks"] = k
                    if k % 5 == 0:
                        raise ValueError("hop failed")
            except ValueError:
                pass
        headers.append(tr.outgoing_headers([("c", "d")]))
    minted = [tracer.maybe_mint() for _ in range(4)]
    recent = _renamed(tracer.recent(), ids)
    head = [[(k, ids.setdefault(v, f"id{len(ids)}")
              if k.startswith("mm-") else v) for k, v in h]
            if isinstance(h, list) else
            (h[0], ids.setdefault(h[1], f"id{len(ids)}") if h[1] else "",
             ids.setdefault(h[2], f"id{len(ids)}") if h[2] else "")
            for h in headers]
    return (recent, head, [bool(m) for m in minted],
            _split_exposition(metrics.render())[1])


def test_tracer_matches_reference():
    ref, port = _both(_trace_script)
    assert ref == port
    recent = ref[0]
    assert len(recent) == 6
    assert any(r.get("error") is None and r["parent_id"] for r in recent)
    assert any(s.get("error") == "ValueError" for r in recent
               for s in r["spans"])
    assert port_tracing.TRACE_HEADER == ref_tracing.TRACE_HEADER
    assert port_tracing.SPAN_HEADER == ref_tracing.SPAN_HEADER
    assert port_tracing.TRACE_DUMP_ID == ref_tracing.TRACE_DUMP_ID


def _flightrec_script(pkg, vc):
    rec = pkg.flightrec.FlightRecorder(capacity=32, instance_id="i-2")
    off = pkg.flightrec.FlightRecorder(capacity=0)
    rng = np.random.default_rng(6)
    for k in range(100):
        rec.record(["state", "placement", "cas-failed"][k % 3],
                   model=f"m{int(rng.integers(0, 5))}", n=k)
        off.record("state", n=k)
        vc.advance(int(rng.integers(0, 3)))
    return rec.dump(), rec.dump(5), len(rec), off.dump(), len(off)


def test_flight_recorder_matches_reference():
    ref, port = _both(_flightrec_script)
    assert ref == port
    assert ref[2] == 32 and ref[4] == 0
    assert port_flightrec.FLIGHTREC_DUMP_ID == ref_flightrec.FLIGHTREC_DUMP_ID


SLO_SPECS = [
    "default:p99<250ms,availability>0.999",
    "hot:p50<10ms,p95<40ms,p99<80ms;default:p99<1000ms",
    "llm:availability>0.99;cv:p95<20ms",
    "",
]


@pytest.mark.parametrize("spec", SLO_SPECS)
def test_slo_spec_parse_matches_reference(spec):
    def parse(mod):
        try:
            return {k: dataclasses.asdict(v)
                    for k, v in mod.parse_slo_spec(spec).items()}
        except ValueError as e:
            return ("ValueError", str(e))

    assert parse(ref_slo) == parse(port_slo)


def _slo_script(pkg, vc):
    metrics = pkg.metrics.PrometheusMetrics(start_server=False)
    slo = pkg.slo.SloTracker(spec=SLO_SPECS[1], metrics=metrics,
                             window_ms=5000)
    rng = np.random.default_rng(7)
    snaps = []
    for k in range(600):
        cls = ["hot", "other", "hot", "default"][k % 4]
        slo.record(cls, float(np.round(rng.exponential(30.0), 2)),
                   bool(rng.random() > 0.02))
        vc.advance(int(rng.integers(0, 30)))
        if k % 97 == 0:
            snaps.append([dataclasses.asdict(slo.attainment(c))
                          for c in ("hot", "default", "nope")])
    slo.export()
    return snaps, slo.classes(), _split_exposition(metrics.render())[1]


def test_slo_tracker_matches_reference():
    ref, port = _both(_slo_script)
    assert ref == port
    assert any(s["violations"] for snap in ref[0] for s in snap)


def _admission_script(pkg, vc):
    slo = pkg.slo.SloTracker(spec="gold:p99<50ms;silver:p99<50ms;"
                             "default:p99<50ms", window_ms=10_000)
    rec = pkg.flightrec.FlightRecorder(capacity=256)
    metrics = pkg.metrics.PrometheusMetrics(start_server=False)
    ctl = pkg.admission.AdmissionController(slo, enabled=True, queue_ms=0,
                                            metrics=metrics, flightrec=rec)
    off = pkg.admission.AdmissionController(slo, enabled=False)
    rng = np.random.default_rng(8)
    decisions = []
    for k in range(400):
        cls = ["gold", "silver", "bronze"][int(rng.integers(0, 3))]
        burning = 100 <= k < 250
        slo.record("gold", 500.0 if burning else 5.0, True)
        try:
            ctl.admit(cls)
            decisions.append((k, cls, "admit"))
        except pkg.errors.OverloadShedError as e:
            decisions.append((k, cls, "shed", e.model_class, str(e)))
        off.admit(cls)
        vc.advance(int(rng.integers(5, 40)))
    return (decisions, ctl.shed_count, ctl.queued_count,
            ctl.throttled_classes(), rec.dump(),
            _split_exposition(metrics.render())[1])


def test_admission_decisions_match_reference():
    ref, port = _both(_admission_script)
    assert ref == port
    assert ref[1] > 0
    # The first class of the spec is never shed; "bronze" is "default's".
    assert {d[3] for d in ref[0] if d[2] == "shed"} <= {"silver",
                                                         "default"}


def _rate_script(pkg, vc):
    rate = pkg.rate.RateTracker()
    rng = np.random.default_rng(9)
    out = []
    for _ in range(200):
        rate.record(int(rng.integers(1, 5)))
        vc.advance(int(rng.integers(0, 20_000)))
        out.append((rate.rpm(), rate.rpm(1), rate.rpm(30)))
    return out


def test_rate_tracker_matches_reference():
    ref, port = _both(_rate_script)
    assert ref == port
    assert any(r[0] for r in ref)


def _pool_run(pkg, workers: int) -> tuple:
    pool = pkg.pool.BoundedDaemonPool(max_workers=workers, name="p")
    order, gate, done = [], threading.Event(), threading.Event()
    lock = threading.Lock()

    def task(k):
        gate.wait(30)
        with lock:
            order.append(k)
            if len(order) == 20:
                done.set()

    def boom():
        gate.wait(30)
        raise RuntimeError("task failure is logged, the pool goes on")

    try:
        assert pool.submit(boom)
        for k in range(20):
            assert pool.submit(task, k)
        pending = pool.pending
        gate.set()
        assert done.wait(30)
    finally:
        pool.shutdown()
    refused = pool.submit(task, 99)
    return order, pending, refused, pool.active_workers <= workers


@pytest.mark.parametrize("workers", [1, 3])
def test_bounded_pool_order_matches_reference(workers):
    ref = _pool_run(REF, workers)
    port = _pool_run(PORT, workers)
    if workers == 1:
        # One worker runs the tasks in submit order in both packages.
        assert ref == port
        assert ref[0] == list(range(20))
    else:
        # Several workers: the order is the threads'; the sets, counts,
        # refusal after shutdown and the worker cap are the packages'.
        assert sorted(ref[0]) == sorted(port[0]) == list(range(20))
        assert ref[1:] == port[1:]
    assert ref[2] is False
    with pytest.raises(ValueError):
        port_pool.BoundedDaemonPool(0)


def test_errors_match_reference():
    names = [n for n in dir(ref_errors) if n.endswith("Error")
             or n == "ModelLoadException"]
    assert names == [n for n in dir(port_errors) if n.endswith("Error")
                     or n == "ModelLoadException"]
    from modelmesh_tpu_torch.runtime import spi

    assert port_errors.ModelLoadException is spi.ModelLoadException
    for name in names:
        r, p = getattr(ref_errors, name), getattr(port_errors, name)
        assert [c.__name__ for c in r.__mro__] == [
            c.__name__ for c in p.__mro__]
    assert str(port_errors.ModelNotHereError("i", "m")) == str(
        ref_errors.ModelNotHereError("i", "m"))
    assert str(port_errors.OverloadShedError("c")) == str(
        ref_errors.OverloadShedError("c"))
    assert str(port_errors.ApplierError("UNAVAILABLE", "x")) == str(
        ref_errors.ApplierError("UNAVAILABLE", "x"))
