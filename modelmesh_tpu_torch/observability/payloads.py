"""The port's own copy of the JAX package's ``observability/payloads.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Payload processors: observe/export request+response payloads.

Capability parity with the reference's payload subsystem (payload/*,
SURVEY.md section 2.4; config grammar at ModelMesh.java:431-463): a
processor interface with logging, matching (model-id/method filter),
composite fan-out, async queued, and remote-HTTP sinks, built from a URI
grammar: ``logger://*?pymsg=...``-style strings become
``logger``, ``http://host/path``, with ``matching`` via
``<processor>?model=<id>&method=<name>``.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import queue
import threading
import urllib.parse
import urllib.request
from typing import Optional, Sequence

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Payload:
    request_id: str
    model_id: str
    method: str
    kind: str                  # "request" | "response"
    data: bytes
    metadata: dict[str, str] = dataclasses.field(default_factory=dict)
    status: str = "OK"


class PayloadProcessor:
    """Return True if ownership of the payload was taken (caller must not
    reuse/release the buffer — mirrors the reference's contract,
    PayloadProcessor.java:26-50)."""

    def process(self, payload: Payload) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LoggingPayloadProcessor(PayloadProcessor):
    def process(self, payload: Payload) -> bool:
        log.info(
            "payload %s %s model=%s method=%s bytes=%d status=%s",
            payload.request_id, payload.kind, payload.model_id,
            payload.method, len(payload.data), payload.status,
        )
        return False


class MatchingPayloadProcessor(PayloadProcessor):
    """Filter by model id and/or method; delegate on match."""

    def __init__(
        self, delegate: PayloadProcessor,
        model_id: Optional[str] = None, method: Optional[str] = None,
    ):
        self.delegate = delegate
        self.model_id = model_id
        self.method = method

    def process(self, payload: Payload) -> bool:
        if self.model_id and payload.model_id != self.model_id:
            return False
        if self.method and not payload.method.endswith(self.method):
            return False
        return self.delegate.process(payload)

    def close(self) -> None:
        self.delegate.close()


class CompositePayloadProcessor(PayloadProcessor):
    def __init__(self, delegates: Sequence[PayloadProcessor]):
        self.delegates = list(delegates)

    def process(self, payload: Payload) -> bool:
        took = False
        for d in self.delegates:
            took = d.process(payload) or took
        return took

    def close(self) -> None:
        for d in self.delegates:
            d.close()


class AsyncPayloadProcessor(PayloadProcessor):
    """Queue + worker; DROPS when the queue is full (never blocks the
    serving path — reference AsyncPayloadProcessor.java)."""

    def __init__(self, delegate: PayloadProcessor, capacity: int = 256,
                 workers: int = 1):
        self.delegate = delegate
        self._q: "queue.Queue[Payload]" = queue.Queue(maxsize=capacity)
        self.dropped = 0
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._run, name=f"payload-{i}", daemon=True)
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    def process(self, payload: Payload) -> bool:
        try:
            self._q.put_nowait(payload)
        except queue.Full:
            self.dropped += 1
        return True  # we own it now (async)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                p = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self.delegate.process(p)
            except Exception:  # noqa: BLE001 — observers must not throw
                log.exception("payload delegate failed")

    def close(self) -> None:
        self._stop.set()
        # Join workers before closing the delegate: an in-flight process()
        # must not race a closed delegate, and remaining queued payloads
        # are accounted as dropped rather than silently vanishing.
        for t in self._threads:
            t.join(timeout=2.0)  #: wall-clock: bounds REAL worker-thread teardown at close
        try:
            while True:
                self._q.get_nowait()
                self.dropped += 1
        except queue.Empty:
            pass
        self.delegate.close()


class RemotePayloadProcessor(PayloadProcessor):
    """HTTP POST of payloads as base64 JSON (reference
    RemotePayloadProcessor.java)."""

    def __init__(self, url: str, timeout_s: float = 5.0):
        self.url = url
        self.timeout_s = timeout_s

    def process(self, payload: Payload) -> bool:
        body = json.dumps({
            "id": payload.request_id,
            "modelid": payload.model_id,
            "method": payload.method,
            "kind": payload.kind,
            "status": payload.status,
            "data": base64.b64encode(payload.data).decode(),
            "metadata": payload.metadata,
        }).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"},
        )
        try:
            urllib.request.urlopen(req, timeout=self.timeout_s).read()
        except Exception as e:  # noqa: BLE001 — observer, not critical path
            log.warning("remote payload POST failed: %s", e)
        return False


def build_processor(uris: Sequence[str]) -> Optional[PayloadProcessor]:
    """Build a processor chain from config URIs.

    Grammar (reference analog, docs/configuration/payloads.md):
      logger                          -> LoggingPayloadProcessor
      http://host:port/path           -> RemotePayloadProcessor
      async:<uri>                     -> AsyncPayloadProcessor wrapper
      <uri>?model=<id>&method=<m>     -> MatchingPayloadProcessor filter
    Multiple URIs fan out via CompositePayloadProcessor.
    """
    processors: list[PayloadProcessor] = []
    for uri in uris:
        uri = uri.strip()
        if not uri:
            continue
        wrap_async = uri.startswith("async:")
        if wrap_async:
            uri = uri[len("async:"):]
        base, _, query = uri.partition("?")
        params = dict(urllib.parse.parse_qsl(query))
        proc: PayloadProcessor
        if base == "logger":
            proc = LoggingPayloadProcessor()
        elif base.startswith("http://") or base.startswith("https://"):
            proc = RemotePayloadProcessor(base)
        else:
            raise ValueError(f"unknown payload processor uri: {uri!r}")
        if "model" in params or "method" in params:
            proc = MatchingPayloadProcessor(
                proc, model_id=params.get("model"), method=params.get("method")
            )
        if wrap_async:
            proc = AsyncPayloadProcessor(proc)
        processors.append(proc)
    if not processors:
        return None
    if len(processors) == 1:
        return processors[0]
    return CompositePayloadProcessor(processors)
