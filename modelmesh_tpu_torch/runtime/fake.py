"""The port's own copy of the JAX package's ``runtime/fake.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Fake model runtime: the test backbone (ExampleModelRuntime equivalent).

A real gRPC server implementing the runtime SPI with simulated load times
and sizes, plus an arbitrary-method inference endpoint that echoes a
deterministic "prediction" for whichever model id arrives in metadata.
Fault injection mirrors what the reference's example runtime supports
(example/ExampleModelRuntime.java, SURVEY.md section 4): per-model load
failure, load delay, NOT_FOUND-on-serve (the Triton refresh quirk), and a
fast mode for cheap tests.

Runnable in-process (tests) or as a subprocess:
    python -m modelmesh_tpu_torch.runtime.fake --port 8085
"""

from __future__ import annotations

import argparse
import logging
import threading
from concurrent import futures
from typing import Optional

import grpc

from modelmesh_tpu_torch.utils.clock import get_clock
from modelmesh_tpu_torch.utils.grpcopts import message_size_options
from modelmesh_tpu_torch.proto import mesh_runtime_pb2 as rpb
from modelmesh_tpu_torch.runtime import grpc_defs

log = logging.getLogger(__name__)

PREDICT_METHOD = "/mmtpu.example.Predictor/Predict"

# Model-id prefixes triggering injected faults (tests construct ids).
FAIL_LOAD_PREFIX = "fail-load-"
SLOW_LOAD_PREFIX = "slow-load-"
NOT_FOUND_SERVE_PREFIX = "vanish-"
# max_concurrency=1 models (latency-mode / cancellation tests).
GATED_PREFIX = "gated-"
# predict sleeps (anywhere in the id, composable with gated-).
SLOW_PREDICT_MARK = "slow-predict"


class FakeRuntimeServicer:
    """Implements mmtpu.runtime.ModelRuntime."""

    def __init__(
        self,
        capacity_bytes: int = 512 << 20,
        default_size_bytes: int = 8 << 20,
        load_delay_s: float = 0.0,
        ready_delay_s: float = 0.0,
        load_concurrency: int = 8,
    ):
        self.capacity_bytes = capacity_bytes
        self.default_size_bytes = default_size_bytes
        self.load_delay_s = load_delay_s
        self._clock = get_clock()
        self._ready_at = self._clock.monotonic() + ready_delay_s
        self.load_concurrency = load_concurrency
        self.loaded: dict[str, int] = {}  # model_id -> size
        self.load_count = 0      # successful loads
        self.load_attempts = 0   # LoadModel RPCs incl. injected failures
        self.unload_count = 0
        # Batched-dispatch accounting (predict_batch): batch count and
        # per-batch sizes, so tests can assert the serving layer's
        # micro-batch queue really coalesced concurrent requests.
        self.batch_calls = 0      #: guarded-by: _lock
        self.batch_sizes: list[int] = []  #: guarded-by: _lock
        self._lock = threading.Lock()

    # -- SPI methods ----------------------------------------------------------

    def RuntimeStatus(self, request, context):
        status = (
            rpb.RuntimeStatusResponse.READY
            if self._clock.monotonic() >= self._ready_at
            else rpb.RuntimeStatusResponse.STARTING
        )
        return rpb.RuntimeStatusResponse(
            status=status,
            capacity_bytes=self.capacity_bytes,
            load_concurrency=self.load_concurrency,
            load_timeout_ms=30_000,
            default_model_size_bytes=self.default_size_bytes,
            runtime_version="fake-0.1",
        )

    def LoadModel(self, request, context):
        mid = request.model_id
        with self._lock:
            self.load_attempts += 1
        if mid.startswith(FAIL_LOAD_PREFIX):
            context.abort(grpc.StatusCode.INTERNAL, f"injected load failure: {mid}")
        delay = self.load_delay_s
        if mid.startswith(SLOW_LOAD_PREFIX):
            delay = max(delay, 2.0)
        if delay:
            self._clock.sleep(delay)
        size = self._size_for(mid)
        with self._lock:
            self.loaded[mid] = size
            self.load_count += 1
        return rpb.LoadModelResponse(
            size_bytes=size,
            max_concurrency=1 if mid.startswith(GATED_PREFIX) else 0,
        )

    def UnloadModel(self, request, context):
        with self._lock:
            self.loaded.pop(request.model_id, None)
            self.unload_count += 1
        return rpb.UnloadModelResponse()

    def PredictModelSize(self, request, context):
        return rpb.ModelSizeResponse(size_bytes=self._size_for(request.model_id))

    def ModelSize(self, request, context):
        size = self.loaded.get(request.model_id, 0)
        return rpb.ModelSizeResponse(size_bytes=size)

    def _size_for(self, model_id: str) -> int:
        # Deterministic per-id size: default +/- up to 50%. A real
        # digest, not builtin hash() — that one is salted per process,
        # so "deterministic" sizes would diverge across test processes
        # (same fix as SimLoader._size_for).
        import zlib

        h = zlib.crc32(model_id.encode()) % 1000
        return int(self.default_size_bytes * (0.5 + h / 1000.0))

    # -- inference ----------------------------------------------------------

    def predict(self, method: str, request: bytes, context) -> bytes:
        md = dict(context.invocation_metadata())
        self.last_predict_metadata = md  #: shared-ok: test-introspection hook; last-writer-wins by design
        mid = md.get(grpc_defs.MODEL_ID_HEADER, "")
        if not mid:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, "missing mm-model-id header"
            )
        with self._lock:
            present = mid in self.loaded
        if not present or mid.startswith(NOT_FOUND_SERVE_PREFIX):
            # The Triton/MLServer quirk: runtime lost the model
            # (reference handling at SidecarModelMesh.java:304-322, 961-988).
            context.abort(grpc.StatusCode.NOT_FOUND, f"model {mid} not loaded")
        if SLOW_PREDICT_MARK in mid:
            self._clock.sleep(3.0)
        if method.endswith("/Echo"):
            # Large-payload data-plane probe: response mirrors the request,
            # exercising the send path at the same size as the receive path.
            return request
        # Deterministic "prediction": classify payload by hash.
        label = (len(request) + sum(request[:16])) % 10
        return f"{mid}:category_{label}".encode()

    def predict_batch(self, items) -> list:
        """Deterministic batched twin of ``predict`` (direct-call, no
        gRPC context): per-item results are byte-identical to N solo
        calls — the batched-vs-sequential identity the serving layer's
        parity tests pin — with per-item fault isolation (a missing or
        vanish- model fails only its own slot) and batch accounting for
        queue assertions. One slow-predict member costs the batch ONE
        virtual sleep (a fused dispatch is one kernel), not N.

        ``items`` are ``runtime.spi.BatchItem``-shaped (model_id,
        payload attrs).
        """
        from modelmesh_tpu_torch.runtime.spi import ModelNotLoadedError

        with self._lock:
            self.batch_calls += 1
            self.batch_sizes.append(len(items))
        if any(SLOW_PREDICT_MARK in item.model_id for item in items):
            self._clock.sleep(3.0)
        out: list = []
        for item in items:
            mid = item.model_id
            with self._lock:
                present = mid in self.loaded
            if not present or mid.startswith(NOT_FOUND_SERVE_PREFIX):
                out.append(ModelNotLoadedError(mid))
                continue
            request = item.payload
            if (getattr(item, "method", "") or "").endswith("/Echo"):
                # Mirror the solo path's large-payload Echo probe.
                out.append(request)
                continue
            label = (len(request) + sum(request[:16])) % 10
            out.append(f"{mid}:category_{label}".encode())
        return out


def start_fake_runtime(
    port: int = 0,
    servicer: Optional[FakeRuntimeServicer] = None,
    max_workers: int = 16,
    uds_path: Optional[str] = None,
) -> tuple[grpc.Server, int, FakeRuntimeServicer]:
    """Start on localhost (or a unix socket); returns (server, bound_port,
    servicer). With ``uds_path`` the returned port is 0 and clients dial
    ``unix://<path>`` — the sidecar-pod transport (SidecarModelMesh.java:991
    buildLocalChannel)."""
    servicer = servicer or FakeRuntimeServicer()
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=message_size_options(),
    )
    grpc_defs.add_servicer(
        server, servicer, grpc_defs.RUNTIME_SERVICE, grpc_defs.RUNTIME_METHODS
    )
    server.add_generic_rpc_handlers(
        (grpc_defs.RawFallbackHandler(servicer.predict),)
    )
    bound = grpc_defs.bind_server(server, port, uds_path=uds_path or "")
    server.start()
    return server, bound, servicer


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=8085)
    parser.add_argument("--capacity-mb", type=int, default=512)
    parser.add_argument("--load-delay-s", type=float, default=0.0)
    parser.add_argument("--ready-delay-s", type=float, default=0.0)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    server, port, _ = start_fake_runtime(
        args.port,
        FakeRuntimeServicer(
            capacity_bytes=args.capacity_mb << 20,
            load_delay_s=args.load_delay_s,
            ready_delay_s=args.ready_delay_s,
        ),
    )
    log.info("fake runtime on :%d", port)
    server.wait_for_termination()


if __name__ == "__main__":
    main()
