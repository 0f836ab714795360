"""The port's own copy of the JAX package's ``runtime/sidecar.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Sidecar model-runtime client: ModelLoader over the gRPC runtime SPI.

The coupling layer to an external model-server container, capability-parity
with the reference's SidecarModelMesh external-loader path
(SidecarModelMesh.java): startup status polling until READY
(waitForModelServerStart :597), load/unload via the SPI with ref-counted
pairing so out-of-order load/unload cancel out (:838-868), a background
unload retry queue so failed unloads don't silently leak serving memory
(:129, :876-944), and inference passthrough to the serving channel with the
model id in metadata.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Optional

import grpc

from modelmesh_tpu_torch.observability.tracing import outgoing_headers
from modelmesh_tpu_torch.utils.grpcopts import message_size_options
from modelmesh_tpu_torch.proto import mesh_runtime_pb2 as rpb
from modelmesh_tpu_torch.runtime import grpc_defs
from modelmesh_tpu_torch.utils.clock import get_clock
from modelmesh_tpu_torch.runtime.spi import (
    LoadedModel,
    LocalInstanceParams,
    ModelInfo,
    ModelLoader,
    ModelLoadException,
)

log = logging.getLogger(__name__)

UNLOAD_MAX_RETRIES = 90           # reference: ~15 min at 10 s intervals
UNLOAD_RETRY_INTERVAL_S = 10.0


class SidecarRuntime(ModelLoader[str]):
    """gRPC-backed loader. The runtime handle is the model id itself; actual
    inference goes through ``call_model`` on the serving channel."""

    def __init__(
        self,
        target: str = "localhost:8085",
        startup_timeout_s: float = 120.0,
        poll_interval_s: float = 1.0,
        channel: Optional[grpc.Channel] = None,
        tls=None,
    ):
        """``tls`` (serving.tls.TlsConfig) secures the runtime link — needed
        whenever the model server isn't a loopback/UDS sidecar."""
        if channel is None:
            if tls is not None:
                from modelmesh_tpu_torch.serving.tls import secure_channel

                channel = secure_channel(target, tls)
            else:
                channel = grpc.insecure_channel(
                    target, options=message_size_options()
                )
        self._channel = channel
        self._stub = grpc_defs.make_stub(
            self._channel, grpc_defs.RUNTIME_SERVICE, grpc_defs.RUNTIME_METHODS
        )
        self._startup_timeout_s = startup_timeout_s
        self._poll_interval_s = poll_interval_s
        # Ref-counted load state: +1 per load, -1 per unload; a model is
        # unloaded from the runtime only when the count returns to 0, so
        # out-of-order load/unload pairs cancel (reference :838-868).
        self._load_counts: dict[str, int] = {}
        self._counts_lock = threading.Lock()
        self._unload_queue: "queue.Queue[tuple[str, int]]" = queue.Queue()
        self._closed = threading.Event()
        self._unload_thread = threading.Thread(
            target=self._unload_retry_loop, name="unload-retry", daemon=True
        )
        self._unload_thread.start()
        self._params: Optional[LocalInstanceParams] = None

    # -- SPI ------------------------------------------------------------------

    def startup(self) -> LocalInstanceParams:
        clock = get_clock()
        deadline = clock.monotonic() + self._startup_timeout_s
        last_err: Optional[str] = None
        while clock.monotonic() < deadline:
            try:
                st = self._stub.RuntimeStatus(rpb.RuntimeStatusRequest())
                if st.status == rpb.RuntimeStatusResponse.READY:
                    self._params = LocalInstanceParams(
                        capacity_bytes=st.capacity_bytes,
                        load_concurrency=st.load_concurrency or 8,
                        load_timeout_ms=st.load_timeout_ms or 240_000,
                        default_model_size_bytes=st.default_model_size_bytes
                        or (1 << 20),
                        limit_model_concurrency=st.limit_model_concurrency,
                    )
                    return self._params
                last_err = rpb.RuntimeStatusResponse.Status.Name(st.status)
            except grpc.RpcError as e:
                last_err = f"{e.code()}: {e.details()}"
            clock.sleep(self._poll_interval_s)
        raise ModelLoadException(
            f"model runtime not ready within {self._startup_timeout_s}s "
            f"(last: {last_err})",
            timeout=True,
        )

    def load(self, model_id: str, info: ModelInfo) -> LoadedModel[str]:
        with self._counts_lock:
            self._load_counts[model_id] = self._load_counts.get(model_id, 0) + 1
            count = self._load_counts[model_id]
        if count > 1:
            # Already loaded in the runtime (re-load paired with a pending
            # unload); just bump the refcount.
            return LoadedModel(handle=model_id)
        try:
            resp = self._stub.LoadModel(
                rpb.LoadModelRequest(
                    model_id=model_id,
                    info=rpb.ModelInfo(
                        model_type=info.model_type,
                        model_path=info.model_path,
                        model_key=info.model_key,
                    ),
                )
            )
        except grpc.RpcError as e:
            with self._counts_lock:
                self._load_counts[model_id] -= 1
                if self._load_counts[model_id] <= 0:
                    del self._load_counts[model_id]
            raise ModelLoadException(
                f"loadModel({model_id}) failed: {e.code()}: {e.details()}",
                timeout=e.code() == grpc.StatusCode.DEADLINE_EXCEEDED,
            ) from e
        return LoadedModel(
            handle=model_id,
            size_bytes=resp.size_bytes,
            max_concurrency=resp.max_concurrency,
        )

    def predict_size(self, model_id: str, info: ModelInfo) -> int:
        try:
            resp = self._stub.PredictModelSize(
                rpb.PredictModelSizeRequest(
                    model_id=model_id,
                    info=rpb.ModelInfo(
                        model_type=info.model_type,
                        model_path=info.model_path,
                        model_key=info.model_key,
                    ),
                )
            )
            return resp.size_bytes
        except grpc.RpcError:
            return 0

    def model_size(self, model_id: str, handle: str) -> int:
        try:
            return self._stub.ModelSize(
                rpb.ModelSizeRequest(model_id=model_id)
            ).size_bytes
        except grpc.RpcError:
            return 0

    def unload(self, model_id: str) -> None:
        with self._counts_lock:
            count = self._load_counts.get(model_id, 0) - 1
            if count > 0:
                self._load_counts[model_id] = count
                return  # paired with an outstanding load; runtime keeps it
            self._load_counts.pop(model_id, None)
        self._try_unload(model_id, attempt=0)

    def _try_unload(self, model_id: str, attempt: int) -> None:
        try:
            # Deadline-bounded: a hung runtime must not wedge the caller —
            # unloads run on the instance's small shared pool, where one
            # unbounded RPC would block every queued unload's capacity
            # accounting. DEADLINE_EXCEEDED lands in the retry queue below.
            self._stub.UnloadModel(
                rpb.UnloadModelRequest(model_id=model_id), timeout=30.0
            )
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.NOT_FOUND:
                return  # already gone
            if attempt + 1 >= UNLOAD_MAX_RETRIES:
                # Capacity is considered lost (reference gives up after ~15
                # min and logs loudly, SidecarModelMesh.java:876-944).
                log.error(
                    "unload of %s failed %d times; capacity presumed lost",
                    model_id, attempt + 1,
                )
                return
            self._unload_queue.put((model_id, attempt + 1))

    def _unload_retry_loop(self) -> None:
        while not self._closed.is_set():
            try:
                model_id, attempt = self._unload_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            if self._closed.wait(UNLOAD_RETRY_INTERVAL_S):
                return
            with self._counts_lock:
                if self._load_counts.get(model_id, 0) > 0:
                    continue  # got re-loaded meanwhile; retry is moot
            self._try_unload(model_id, attempt)

    # -- inference --------------------------------------------------------------

    def call_model(
        self,
        model_id: str,
        full_method: str,
        payload: bytes,
        headers: Optional[list[tuple[str, str]]] = None,
        timeout_s: Optional[float] = None,
        cancel_event=None,
    ) -> bytes:
        """Invoke an arbitrary method on the runtime with the model id header
        (reference ExternalModel.callModel, SidecarModelMesh.java:337-510).
        The trace context rides this hop too (outgoing_headers attaches
        the live trace id + span once), so runtime-side tooling can join
        mesh traces — previously the runtime-SPI hop silently dropped it."""
        md = outgoing_headers(
            [(grpc_defs.MODEL_ID_HEADER, model_id)] + (headers or [])
        )
        call = grpc_defs.raw_method(self._channel, full_method)
        if cancel_event is None:
            return call(payload, metadata=md, timeout=timeout_s)
        return grpc_defs.call_cancellable(
            call, payload, timeout=timeout_s, metadata=md,
            cancel_event=cancel_event,
        )

    def close(self) -> None:
        self._closed.set()
        self._channel.close()

    @property
    def requires_unload(self) -> bool:
        return True
