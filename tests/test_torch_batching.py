"""The port's continuous batcher (``modelmesh_tpu_torch/serving/
batching.py``) against the JAX package's, on the CPU.

One arrival script goes through both packages' ``RequestBatcher`` with
stub calls: each wave holds its group busy with a passthrough request
parked on a gate, parks the rest of the wave behind it one request at a
time (so the queue's order is the script's), withdraws the wave's
cancelled requests, then opens the gate. Held equal across packages:

- the calls the batcher made: passthroughs, and each batched dispatch's
  composition (which models, in which order, and whether a cancel event
  reached the call);
- every request's outcome: its bytes, ``BatchCancelled``, the per-item
  error its slot of the batch returned, or the collective failure of a
  batch whose call raised;
- the counters, the flight recorder's events and the metrics exposition.

The scripted runs use a zero fill window under each package's
``VirtualClock``; one more run under the real clock with a 2 ms window
compares the compositions.
"""

import contextlib
import threading
import time
import types

import numpy as np
import pytest

import modelmesh_tpu.observability.flightrec as ref_flightrec
import modelmesh_tpu.observability.metrics as ref_metrics
import modelmesh_tpu.serving.batching as ref_batching
import modelmesh_tpu.utils.clock as ref_clock
import modelmesh_tpu_torch.observability.flightrec as port_flightrec
import modelmesh_tpu_torch.observability.metrics as port_metrics
import modelmesh_tpu_torch.serving.batching as port_batching
import modelmesh_tpu_torch.utils.clock as port_clock

REF = types.SimpleNamespace(batching=ref_batching, metrics=ref_metrics,
                            flightrec=ref_flightrec, clock=ref_clock)
PORT = types.SimpleNamespace(batching=port_batching, metrics=port_metrics,
                             flightrec=port_flightrec, clock=port_clock)
GROUPS = ["a", "b", "c"]
WAIT_S = 10.0


def _wait(pred, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.001)


def _answer(model_id: str, payload: bytes) -> bytes:
    return model_id.encode() + b":" + payload[::-1]


def _script(seed: int, waves: int = 6) -> list:
    """Waves of (group, [(model, payload, cancelled)]): models of a group
    share its queue (the fused-group key); payload b"bad" fails its own
    slot, b"boom" fails its whole batch."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(waves):
        g = GROUPS[int(rng.integers(0, len(GROUPS)))]
        reqs = []
        for k in range(int(rng.integers(0, 12))):
            mid = f"{g}-{int(rng.integers(0, 3))}"
            r = rng.random()
            payload = (b"bad" if r < 0.08 else b"boom" if r < 0.11
                       else bytes(rng.integers(0, 256, 4, dtype=np.uint8)))
            reqs.append((mid, payload, bool(rng.random() < 0.1)))
        out.append((g, reqs))
    return out


def _run(pkg, script, batch_max: int = 4, window_us: int = 0,
         virtual: bool = True) -> dict:
    ctx = (pkg.clock.installed(pkg.clock.VirtualClock()) if virtual
           else contextlib.nullcontext())
    with ctx:
        return _run_waves(pkg, script, batch_max, window_us)


def _run_waves(pkg, script, batch_max, window_us) -> dict:
    calls: list = []
    gate = threading.Event()
    metrics = pkg.metrics.PrometheusMetrics(start_server=False)
    rec = pkg.flightrec.FlightRecorder(capacity=1024)

    def call_one(req):
        calls.append(("one", req.model_id))
        if req.payload == b"hold":
            assert gate.wait(WAIT_S)
        if req.payload == b"bad":
            raise ValueError(f"bad request for {req.model_id}")
        return _answer(req.model_id, req.payload)

    def call_many(items, cancel_event=None):
        calls.append(("many", [i.model_id for i in items],
                      cancel_event is not None))
        if any(i.payload == b"boom" for i in items):
            raise RuntimeError("the batched dispatch failed")
        return [ValueError(f"bad item for {i.model_id}")
                if i.payload == b"bad" else _answer(i.model_id, i.payload)
                for i in items]

    batcher = pkg.batching.RequestBatcher(
        call_one, call_many, group_key=lambda mid: mid.split("-")[0],
        batch_max=batch_max, window_us=window_us, metrics=metrics,
        flightrec=rec)
    outcomes = []
    for group, reqs in script:
        gate.clear()
        results: dict = {}

        def submit(k, mid, payload, cancel):
            try:
                results[k] = ("ok", batcher.submit(
                    mid, "predict", payload, [], cancel_event=cancel))
            except pkg.batching.BatchCancelled as e:
                results[k] = ("cancelled", str(e))
            except Exception as e:  # noqa: BLE001 — the outcome compared
                results[k] = ("error", type(e).__name__, str(e))

        n_calls = len(calls)
        holder = threading.Thread(
            target=submit, args=(-1, f"{group}-hold", b"hold", None))
        holder.start()
        _wait(lambda: len(calls) > n_calls, "the passthrough started")
        threads, cancels = [], []
        for k, (mid, payload, cancelled) in enumerate(reqs):
            ev = threading.Event() if cancelled else None
            if ev is not None:
                cancels.append(ev)
            th = threading.Thread(target=submit, args=(k, mid, payload, ev))
            th.start()
            threads.append(th)
            _wait(lambda k=k: batcher.parked_total == k + 1,
                  "the request parking")
        parked = batcher.parked_total
        for ev in cancels:
            ev.set()
        _wait(lambda: batcher.parked_total == parked - len(cancels),
              "the cancelled requests withdrawing")
        depth = batcher.depth(f"{group}-0")
        gate.set()
        for th in [holder] + threads:
            th.join(WAIT_S)
        outcomes.append((depth, sorted(results.items())))
        assert batcher.flush(f"{group}-0", timeout_s=WAIT_S)
    # A lone request on an idle group takes the passthrough.
    solo = batcher.submit("z-0", "predict", b"solo", [])
    events = [{k: v for k, v in e.items() if k != "ts_ms"}
              for e in rec.dump()]
    text = [ln for ln in metrics.render().splitlines()
            if "batch" in ln or "fused" in ln]
    return {"calls": calls, "outcomes": outcomes, "solo": solo,
            "counts": (batcher.solo_count, batcher.batch_count,
                       batcher.batched_requests, batcher.queue_depth()),
            "events": events, "metrics": text}


@pytest.mark.parametrize("seed,batch_max", [(0, 4), (1, 8), (2, 3)])
def test_batch_script_matches_reference(seed, batch_max):
    script = _script(seed)
    ref = _run(REF, script, batch_max)
    port = _run(PORT, script, batch_max)
    assert ref == port
    kinds = {o[1][0] for _, res in ref["outcomes"] for o in res}
    assert {"ok", "cancelled"} <= kinds
    assert any(c[0] == "many" and len(set(c[1])) > 1 for c in ref["calls"])
    assert ref["solo"] == b"z-0:olos"


def test_batch_errors_map_per_item_and_per_batch():
    """A slot's exception fails that request only; a raising dispatch
    fails every request of its batch, in both packages alike."""
    script = [("a", [("a-0", b"xy", False), ("a-1", b"bad", False),
                     ("a-2", b"zw", False)]),
              ("b", [("b-0", b"q", False), ("b-1", b"boom", False),
                     ("b-0", b"r", False)])]
    ref, port = _run(REF, script), _run(PORT, script)
    assert ref == port
    a, b = (dict(res) for _, res in ref["outcomes"])
    assert a[0] == ("ok", b"a-0:yx") and a[2] == ("ok", b"a-2:wz")
    assert a[1] == ("error", "ValueError", "bad item for a-1")
    assert all(b[k] == ("error", "RuntimeError",
                        "the batched dispatch failed") for k in range(3))
    assert ref["calls"][1] == ("many", ["a-0", "a-1", "a-2"], False)


def test_fill_window_compositions_match_reference():
    """A 2 ms fill window under the real clock: the compositions are the
    zero-window runs' (every request parked before the gate opened)."""
    script = _script(3, waves=4)
    ref = _run(REF, script, 4, window_us=2000, virtual=False)
    port = _run(PORT, script, 4, window_us=2000, virtual=False)
    assert ref["calls"] == port["calls"]
    assert ref["outcomes"] == port["outcomes"]
    assert ref["calls"] == _run(PORT, script, 4)["calls"]
