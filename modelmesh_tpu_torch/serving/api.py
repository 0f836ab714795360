"""The port's own copy of the JAX package's ``serving/api.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

gRPC surfaces of a serving instance.

Three handlers on one server (reference: ModelMeshApi.java single server
with management service + arbitrary-method fallback; internal thrift service
replaced by the MeshInternal gRPC service):

- mmtpu.api.ModelMesh        — management (register/status/vmodels)
- mmtpu.internal.MeshInternal — instance-to-instance forwarding
- raw fallback handler        — ANY other unary method is inference: model id
  from mm-model-id / mm-vmodel-id metadata, payload passed through opaque
  (zero-copy equivalent of ModelMeshApi.startCall :649-819)

Also provides the client side: ``grpc_peer_call`` used as the instance's
peer transport, with mesh errors mapped onto gRPC status + a detail header.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time as _time
from concurrent import futures
from typing import Optional

import grpc

from modelmesh_tpu_torch.utils.grpcopts import message_size_options
from modelmesh_tpu_torch.observability.metrics import Metric as MX
from modelmesh_tpu_torch.observability.payloads import Payload
from modelmesh_tpu_torch.observability.tracing import (
    SPAN_HEADER,
    TRACE_HEADER,
    Tracer,
    incoming_parent_span,
    incoming_trace_id,
)

from modelmesh_tpu_torch.proto import mesh_api_pb2 as apb
from modelmesh_tpu_torch.proto import mesh_internal_pb2 as ipb
from modelmesh_tpu_torch.proto import mesh_transfer_pb2 as tpb
from modelmesh_tpu_torch.runtime import grpc_defs
from modelmesh_tpu_torch.runtime.spi import ModelInfo
from modelmesh_tpu_torch.serving.errors import (
    RequestCancelledError,
    ApplierError,
    ModelLoadException,
    ModelNotFoundError,
    ModelNotHereError,
    NoCapacityError,
    OverloadShedError,
    ReadOnlyModeError,
    ServiceUnavailableError,
)
from modelmesh_tpu_torch.serving.instance import (
    InvokeResult,
    ModelMeshInstance,
    RoutingContext,
)
from modelmesh_tpu_torch.serving.route_cache import LoadFeedback

log = logging.getLogger(__name__)

ERROR_HEADER = "mm-error"
_ERR_NOT_HERE = "model-not-here"
_ERR_NO_CAPACITY = "no-capacity"
_ERR_LOAD_FAILED = "load-failed"
# Piggybacked load feedback on Forward responses (the responder's
# in-flight count, batch-queue depth, drain flag — route_cache.
# LoadFeedback wire form). A trailer, not a message field: zero bytes
# on requests, and older peers simply don't send it.
LOAD_HEADER = "mm-load"
# Typed overload marker on admission sheds, beside RESOURCE_EXHAUSTED:
# lets clients (and tests) tell a deliberate edge shed from a fleet
# genuinely out of placement capacity.
OVERLOAD_HEADER = "mm-overload"

_STATUS_MAP = {
    "NOT_FOUND": apb.NOT_FOUND,
    "NOT_LOADED": apb.NOT_LOADED,
    "LOADING": apb.LOADING,
    "LOADED": apb.LOADED,
    "LOADING_FAILED": apb.LOADING_FAILED,
}


def _ctx_to_proto(ctx: RoutingContext) -> ipb.RoutingContext:
    # Sets are serialized in iteration order: the receiver rebuilds sets
    # (order-insensitive), and sorting three sets per forward hop was pure
    # hot-path overhead.
    return ipb.RoutingContext(
        hop=ctx.hop,
        exclude_serve=list(ctx.exclude_serve),
        exclude_load=list(ctx.exclude_load),
        visited=list(ctx.visited),
        dest_instance=ctx.dest_instance,
        chain_load_count=ctx.chain_load_count,
        known_size_bytes=ctx.known_size_bytes,
        last_used_ms=ctx.last_used_ms,
    )


def _ctx_from_proto(p: ipb.RoutingContext) -> RoutingContext:
    return RoutingContext(
        hop=p.hop,
        exclude_serve=set(p.exclude_serve),
        exclude_load=set(p.exclude_load),
        visited=set(p.visited),
        dest_instance=p.dest_instance,
        chain_load_count=p.chain_load_count,
        known_size_bytes=p.known_size_bytes,
        last_used_ms=p.last_used_ms,
    )


class MeshApiServicer:
    """mmtpu.api.ModelMesh implementation."""

    def __init__(self, instance: ModelMeshInstance, vmodels=None):
        self.instance = instance
        self.vmodels = vmodels  # VModelManager, optional

    def _status_info(self, model_id: str) -> apb.ModelStatusInfo:
        status, mr = self.instance.get_status(model_id)
        errors = []
        if mr is not None:
            errors = [msg for _, msg in mr.load_failures.values()]
        return apb.ModelStatusInfo(
            status=_STATUS_MAP.get(status, apb.UNKNOWN),
            errors=errors,
            model_id=model_id,
            copy_count=mr.copy_count if mr else 0,
        )

    @staticmethod
    def _require_id(id_: str, context, what: str = "model_id") -> None:
        if not id_ or "/" in id_:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"{what} must be non-empty and must not contain '/'",
            )

    def RegisterModel(self, request, context):
        self._require_id(request.model_id, context)
        info = ModelInfo(
            model_type=request.info.model_type,
            model_path=request.info.model_path,
            model_key=request.info.model_key,
        )
        try:
            self.instance.register_model(
                request.model_id, info,
                load_now=request.load_now, sync=request.sync,
            )
        except ReadOnlyModeError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        except Exception as e:  # noqa: BLE001 — map to status
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        return self._status_info(request.model_id)

    def UnregisterModel(self, request, context):
        self._require_id(request.model_id, context)
        try:
            self.instance.unregister_model(request.model_id)
        except ReadOnlyModeError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        return apb.UnregisterModelResponse()

    def GetModelStatus(self, request, context):
        # Reserved diagnostic id: dump full cache + cluster state (the
        # reference's ***LOGCACHE***/***GETSTATE*** facility).
        from modelmesh_tpu_torch.serving.bootstrap import (
            STATE_DUMP_ALIASES,
            STATE_DUMP_ID,
            debug_dump,
        )

        if request.model_id in STATE_DUMP_ALIASES:
            import json as _json

            return apb.ModelStatusInfo(
                status=apb.UNKNOWN,
                model_id=STATE_DUMP_ID,
                errors=[_json.dumps(debug_dump(self.instance))],
            )
        from modelmesh_tpu_torch.observability.flightrec import FLIGHTREC_DUMP_ID
        from modelmesh_tpu_torch.observability.tracing import TRACE_DUMP_ID

        if request.model_id == TRACE_DUMP_ID:
            import json as _json

            tracer = self.instance.tracer
            return apb.ModelStatusInfo(
                status=apb.UNKNOWN,
                model_id=TRACE_DUMP_ID,
                errors=[_json.dumps(tracer.recent(tracer.capacity))],
            )
        if request.model_id == FLIGHTREC_DUMP_ID:
            import json as _json

            return apb.ModelStatusInfo(
                status=apb.UNKNOWN,
                model_id=FLIGHTREC_DUMP_ID,
                errors=[_json.dumps(self.instance.flightrec.dump())],
            )
        self._require_id(request.model_id, context)
        return self._status_info(request.model_id)

    def EnsureLoaded(self, request, context):
        self._require_id(request.model_id, context)
        # Internal ensure ops ride invocation metadata for trace context
        # (the request proto carries no headers): an upstream-traced
        # ensure keeps its tree; untraced ones sample like any root.
        md = list(context.invocation_metadata())
        try:
            with self.instance.tracer.trace(
                incoming_trace_id(md), request.model_id, "EnsureLoaded",
                parent_span=incoming_parent_span(md),
            ):
                self.instance.ensure_loaded(
                    request.model_id,
                    last_used_ms=request.last_used_ms,
                    sync=request.sync,
                )
        except ModelNotFoundError:
            return apb.ModelStatusInfo(
                status=apb.NOT_FOUND, model_id=request.model_id
            )
        except (ModelLoadException, NoCapacityError) as e:
            return apb.ModelStatusInfo(
                status=apb.LOADING_FAILED, model_id=request.model_id,
                errors=[str(e)],
            )
        return self._status_info(request.model_id)

    # -- vmodels (delegated; UNIMPLEMENTED until manager attached) ---------

    def SetVModel(self, request, context):
        if self.vmodels is None:
            context.abort(grpc.StatusCode.UNIMPLEMENTED, "vmodels not enabled")
        return self.vmodels.set_vmodel(request, context, self._status_info)

    def DeleteVModel(self, request, context):
        if self.vmodels is None:
            context.abort(grpc.StatusCode.UNIMPLEMENTED, "vmodels not enabled")
        return self.vmodels.delete_vmodel(request, context)

    def GetVModelStatus(self, request, context):
        if self.vmodels is None:
            context.abort(grpc.StatusCode.UNIMPLEMENTED, "vmodels not enabled")
        return self.vmodels.get_vmodel_status(request, context, self._status_info)


class MeshInternalServicer:
    """mmtpu.internal.MeshInternal implementation."""

    def __init__(self, instance: ModelMeshInstance):
        self.instance = instance

    def Forward(self, request, context):
        ctx = _ctx_from_proto(request.ctx)
        # Transitive cancellation: when the previous hop cancels its
        # Forward RPC (because ITS client disconnected), this context
        # terminates and the event interrupts local work here too.
        ctx.cancel_event = threading.Event()
        context.add_callback(ctx.cancel_event.set)
        headers = list(request.headers.items())
        incoming_tid = incoming_trace_id(headers)
        incoming_parent = incoming_parent_span(headers)
        if incoming_tid:
            # Trace context never rides the opaque header list downstream:
            # outgoing_headers re-attaches it fresh (with THIS hop's span
            # as the parent) on every outbound hop — a second forward of
            # this request must not inherit hop-1's parent link.
            headers = [
                (k, v) for k, v in headers
                if k != TRACE_HEADER and k != SPAN_HEADER
            ]
        try:
            with self.instance.tracer.trace(
                incoming_tid, request.model_id, request.method_name,
                parent_span=incoming_parent,
            ):
                result = self.instance.invoke_model(
                    request.model_id,
                    request.method_name or None,
                    request.payload,
                    headers,
                    ctx,
                )
        except ModelNotHereError:
            context.set_trailing_metadata(((ERROR_HEADER, _ERR_NOT_HERE),))
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"model {request.model_id} not here",
            )
        except NoCapacityError as e:
            context.set_trailing_metadata(((ERROR_HEADER, _ERR_NO_CAPACITY),))
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except ModelNotFoundError:
            context.abort(
                grpc.StatusCode.NOT_FOUND, f"model {request.model_id}"
            )
        except ServiceUnavailableError as e:
            # Propagates as UNAVAILABLE so the previous hop excludes this
            # instance and retries elsewhere (same mapping as the external
            # fallback surface).
            context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        except ModelLoadException as e:
            # Typed trailer so the forwarding hop can catch
            # ModelLoadException and re-route (it forwarded to a LOADING
            # copy whose load died) instead of failing the request.
            context.set_trailing_metadata(((ERROR_HEADER, _ERR_LOAD_FAILED),))
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        except ApplierError as e:
            context.abort(grpc.StatusCode.UNKNOWN, str(e))
        except RequestCancelledError:
            context.abort(grpc.StatusCode.CANCELLED, "upstream cancelled")
        # Piggybacked load feedback: OUR current load rides every
        # successful Forward response as a trailer, feeding the
        # sender's LoadView (d-choices routing). Best-effort — a
        # context that can't take trailers must not fail the response.
        try:
            context.set_trailing_metadata(
                ((LOAD_HEADER, self.instance.load_feedback().encode()),)
            )
        except Exception:  # noqa: BLE001 — advisory signal only
            pass
        return ipb.ForwardResponse(
            payload=result.payload,
            served_by=result.served_by,
            model_status=_STATUS_MAP.get(result.status, apb.UNKNOWN),
        )

    def FetchWeights(self, request, context):
        """Weight-transfer fetch (live scale-up): one chunk of this
        instance's snapshot of the model. Stateless per call; failures
        the receiver should treat as 'try another source' come back as a
        NOT_AVAILABLE status rather than an RPC error. Trace context
        rides invocation metadata (the fetch client attaches it), so a
        traced receiver's stream shows the sender's chunk serving in the
        same tree — recorded ONCE per transfer (chunk 0): a
        record-per-chunk would evict the sender's whole trace ring on a
        single multi-GB stream."""
        md = list(context.invocation_metadata())
        tid = incoming_trace_id(md) if request.chunk_index == 0 else ""
        if tid:
            with self.instance.tracer.trace(
                tid, request.model_id, "FetchWeights",
                parent_span=incoming_parent_span(md),
            ), self.instance.tracer.span(
                "serve-chunk", chunk=request.chunk_index,
            ):
                reply = self.instance.handle_weight_fetch(
                    request.model_id, request.chunk_index,
                    request.fingerprint,
                )
        else:
            reply = self.instance.handle_weight_fetch(
                request.model_id, request.chunk_index, request.fingerprint
            )
        return tpb.FetchWeightsResponse(
            status=reply.status,
            payload=reply.payload,
            seq=reply.seq,
            layer=reply.layer,
            last=reply.last,
            total_chunks=reply.total_chunks,
            total_bytes=reply.total_bytes,
            total_layers=reply.total_layers,
            fingerprint=reply.fingerprint,
        )


class InferenceFallback:
    """Arbitrary-method inference entry: metadata id -> invoke_model.

    Also the request-metrics and payload-observation point (reference:
    ModelMeshApi request metrics + PayloadProcessor hooks :778-818).
    """

    # Parallelism of multi-model fan-out (reference MM_MULTI_PARALLELISM=4,
    # applyParallelMultiModel ModelMeshApi.java:947-1058).
    MULTI_PARALLELISM = 4

    def __init__(self, instance: ModelMeshInstance, vmodels=None,
                 payload_processor=None, dataplane=None, log_headers=None):
        from modelmesh_tpu_torch.observability.logctx import HeaderLogContext

        self.instance = instance
        self.vmodels = vmodels
        self.payload_processor = payload_processor
        self.dataplane = dataplane  # DataplaneApiConfig, optional
        # Header -> log-context mapping (LogRequestHeaders.java:17-35);
        # parsed from MM_LOG_REQUEST_HEADERS unless injected.
        self.log_headers = log_headers or HeaderLogContext.from_env()
        self._req_seq = itertools.count(1)
        self._multi_pool = futures.ThreadPoolExecutor(
            max_workers=self.MULTI_PARALLELISM, thread_name_prefix="multi"
        )

    def _observe_payload(self, req_id, model_id, method, kind, data, status):
        proc = self.payload_processor
        if proc is None:
            return
        try:
            proc.process(Payload(
                request_id=req_id, model_id=model_id, method=method,
                kind=kind, data=data, status=status,
            ))
        except Exception:  # noqa: BLE001 — observer must not break serving
            log.exception("payload processor failed")

    def __call__(self, method: str, request: bytes, context) -> bytes:
        metrics = self.instance.metrics
        md = dict(context.invocation_metadata())
        if self.dataplane is not None and not self.dataplane.is_allowed(method):
            context.abort(
                grpc.StatusCode.UNIMPLEMENTED,
                f"method {method} not permitted by dataplane config",
            )
        model_id = md.get(grpc_defs.MODEL_ID_HEADER, "")
        vmodel_id = md.get(grpc_defs.VMODEL_ID_HEADER, "")
        if not model_id and not vmodel_id and self.dataplane is not None:
            # In-body id extraction (ProtoSplicer path, reference
            # ModelMeshApi.java:689).
            path = self.dataplane.extraction_path(method)
            if path:
                from modelmesh_tpu_torch.native import proto_splicer

                try:
                    extracted = proto_splicer.extract_id(request, path)
                except ValueError:
                    extracted = None
                if extracted:
                    cfg = self.dataplane.rpc(method)
                    if cfg is not None and cfg.vmodel:
                        vmodel_id = extracted
                    else:
                        model_id = extracted
        if vmodel_id and not model_id:
            if self.vmodels is None:
                context.abort(
                    grpc.StatusCode.UNIMPLEMENTED, "vmodels not enabled"
                )
            model_id = self.vmodels.resolve(vmodel_id, context)
        if not model_id:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"missing {grpc_defs.MODEL_ID_HEADER} metadata",
            )
        # Single pass over the metadata: strip transport/id entries into
        # the forwardable header list and capture the trace id on the way
        # (previously: a filtering comprehension here plus a second
        # identical one in the multi-model path plus separate md lookups).
        headers = []
        trace_id = ""
        parent_span = ""
        for k, v in md.items():
            if k.startswith("grpc-") or not isinstance(v, str):
                continue
            if k == grpc_defs.MODEL_ID_HEADER or k == grpc_defs.VMODEL_ID_HEADER:
                continue
            if k == TRACE_HEADER:
                # Captured, NOT forwarded in the opaque list: every
                # outbound hop re-attaches the live trace context with
                # its own span as the parent (outgoing_headers).
                trace_id = v
                continue
            if k == SPAN_HEADER:
                parent_span = v
                continue
            headers.append((k, v))
        if "," in model_id:
            return self._multi_model(
                method, request, context, model_id, headers, trace_id
            )
        # Payload observation (and the req-id it needs) only exists when a
        # processor is configured — the common unconfigured case skips the
        # id formatting and the observer calls entirely.
        proc = self.payload_processor
        req_id = ""
        if proc is not None:
            req_id = f"{self.instance.instance_id}-{next(self._req_seq)}"
            self._observe_payload(
                req_id, model_id, method, "request", request, "OK"
            )
        metrics.inc(MX.API_REQUEST_COUNT, model_id=model_id)
        # Client-disconnect propagation (ModelMeshApi.java:709-729): gRPC
        # fires rpc-termination callbacks on cancel; the event interrupts
        # slot waits, runtime calls, and peer forwards downstream. (It also
        # fires on normal completion — harmless, the request is done.)
        cancel_event = threading.Event()
        context.add_callback(cancel_event.set)
        t0 = _time.perf_counter()  #: wall-clock: perf_counter latency metric (API request time)
        metrics.observe(MX.REQUEST_BYTES, len(request), model_id)
        try:
            with self.log_headers.bind(md.items()), self.instance.tracer.trace(
                trace_id, model_id, method, parent_span=parent_span,
            ):
                result = self.instance.invoke_model(
                    model_id, method, request, headers,
                    RoutingContext(cancel_event=cancel_event),
                )
            metrics.observe(MX.RESPONSE_BYTES, len(result.payload), model_id)
            metrics.observe(
                MX.API_REQUEST_TIME, (_time.perf_counter() - t0) * 1e3,  #: wall-clock: perf_counter latency metric
                model_id=model_id,
            )
            if proc is not None:
                self._observe_payload(
                    req_id, model_id, method, "response", result.payload, "OK"
                )
            # Serving-identity trailers: which worker the connection
            # entered (front-door balancing debug) and which instance
            # actually served — operators and tests read these to see
            # kernel connection spread vs internal forwards.
            try:
                context.set_trailing_metadata((
                    ("mm-entry-instance", self.instance.instance_id),
                    ("mm-served-by", result.served_by or ""),
                ))
            except Exception:  # noqa: BLE001 — debug info, never fatal
                pass
            return result.payload
        except RequestCancelledError:
            # The client is gone; nothing to send. Abort with CANCELLED so
            # the server-side bookkeeping closes out cleanly.
            metrics.inc(MX.API_REQUEST_FAILED, model_id=model_id)
            metrics.inc(MX.CANCEL_COUNT, model_id=model_id)
            context.abort(grpc.StatusCode.CANCELLED, "client cancelled")
        except ModelNotFoundError:
            metrics.inc(MX.API_REQUEST_FAILED, model_id=model_id)
            self._observe_payload(
                req_id, model_id, method, "response", b"", "NOT_FOUND"
            )
            context.abort(grpc.StatusCode.NOT_FOUND, f"model {model_id}")
        except OverloadShedError as e:
            # Deliberate edge shed (serving/admission.py): typed via the
            # mm-overload trailer so clients back off instead of
            # retrying into the same overload.
            metrics.inc(MX.API_REQUEST_FAILED, model_id=model_id)
            try:
                context.set_trailing_metadata(
                    ((OVERLOAD_HEADER, e.model_class),)
                )
            except Exception:  # noqa: BLE001 — marker only
                pass
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except NoCapacityError as e:
            metrics.inc(MX.API_REQUEST_FAILED, model_id=model_id)
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except (ModelLoadException, ModelNotHereError) as e:
            metrics.inc(MX.API_REQUEST_FAILED, model_id=model_id)
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        except ApplierError as e:
            metrics.inc(MX.API_REQUEST_FAILED, model_id=model_id)
            code = getattr(grpc.StatusCode, e.grpc_code, grpc.StatusCode.UNKNOWN)
            context.abort(code, str(e))
        except ServiceUnavailableError as e:
            metrics.inc(MX.API_REQUEST_FAILED, model_id=model_id)
            context.abort(grpc.StatusCode.UNAVAILABLE, str(e))

    def _multi_model(
        self, method, request, context, model_ids, headers, trace_id
    ) -> bytes:
        """Fan the same request out to several models in parallel; responses
        are concatenated as length-prefixed frames (4-byte big-endian per
        response, in the order the ids were given). First failure aborts the
        whole call, mirroring the reference's all-or-nothing semantics.

        ``headers`` already has the routing ids stripped (the caller's
        single metadata pass): each per-model call gets its own id header
        from the runtime client; the original comma-list must not leak
        through (duplicate metadata keys would shadow it)."""
        metrics = self.instance.metrics
        ids = [m.strip() for m in model_ids.split(",") if m.strip()]
        req_id = f"{self.instance.instance_id}-{next(self._req_seq)}"
        metrics.inc(MX.API_REQUEST_COUNT, model_id=model_ids)
        metrics.inc(MX.MULTI_MODEL_COUNT, model_id=model_ids)
        self._observe_payload(req_id, model_ids, method, "request", request, "OK")
        cancel_event = threading.Event()
        context.add_callback(cancel_event.set)
        t0 = _time.perf_counter()  #: wall-clock: perf_counter latency metric (API request time)
        # Adopted ids always trace; a fan-out without one is sampled like
        # any minted root (maybe_mint, not uuid4: no per-request entropy
        # I/O, and sampled-out fan-outs skip tracing entirely instead of
        # letting each member mint a fragment).
        trace_id = trace_id or self.instance.tracer.maybe_mint()

        def run_member(mid):
            # Pool threads don't inherit the handler's trace contextvar:
            # each member records under the SHARED trace id so the fan-out
            # appears as one trace across instances.
            if not trace_id:
                return self.instance.invoke_model(
                    mid, method, request, headers,
                    RoutingContext(cancel_event=cancel_event),
                )
            with self.instance.tracer.trace(trace_id, mid, method):
                return self.instance.invoke_model(
                    mid, method, request, headers,
                    RoutingContext(cancel_event=cancel_event),
                )

        futs = [self._multi_pool.submit(run_member, mid) for mid in ids]
        out = bytearray()
        # Per-model budget tied to the LOAD timeout (a fan-out member may
        # legitimately cold-load), not a flat wall unrelated to it — the
        # round-1 verdict's 60 s INTERNAL failure mode.
        per_model_s = max(60.0, self.instance.load_timeout_s * 1.5 + 30.0)
        try:
            for mid, fut in zip(ids, futs):
                payload = fut.result(timeout=per_model_s).payload
                out += len(payload).to_bytes(4, "big") + payload
        except Exception as e:  # noqa: BLE001 — first failure aborts the call
            for f in futs:
                f.cancel()
            cancel_event.set()  # release in-flight members' slots
            metrics.inc(MX.API_REQUEST_FAILED, model_id=model_ids)
            code, label = {
                ModelNotFoundError: (grpc.StatusCode.NOT_FOUND, "NOT_FOUND"),
                NoCapacityError: (
                    grpc.StatusCode.RESOURCE_EXHAUSTED, "NO_CAPACITY"
                ),
                OverloadShedError: (
                    grpc.StatusCode.RESOURCE_EXHAUSTED, "OVERLOAD"
                ),
                ServiceUnavailableError: (
                    grpc.StatusCode.UNAVAILABLE, "UNAVAILABLE"
                ),
                RequestCancelledError: (
                    grpc.StatusCode.CANCELLED, "CANCELLED"
                ),
            }.get(type(e), (grpc.StatusCode.INTERNAL, "INTERNAL"))
            self._observe_payload(
                req_id, model_ids, method, "response", b"", label
            )
            context.abort(code, f"multi-model {mid}: {e}")
        metrics.observe(
            MX.API_REQUEST_TIME, (_time.perf_counter() - t0) * 1e3,  #: wall-clock: perf_counter latency metric
            model_id=model_ids,
        )
        self._observe_payload(
            req_id, model_ids, method, "response", bytes(out), "OK"
        )
        return bytes(out)


class MeshServer:
    """One gRPC server exposing all three surfaces for an instance."""

    def __init__(
        self,
        instance: ModelMeshInstance,
        port: int = 0,
        vmodels=None,
        max_workers: int = 24,
        bind_host: str = "0.0.0.0",
        advertise_host: str = "127.0.0.1",
        payload_processor=None,
        dataplane=None,
        tls=None,
        frontdoor_port: Optional[int] = None,
    ):
        """``bind_host`` is the listen address (0.0.0.0 for cross-host
        deployments); ``advertise_host`` is what peers dial — production
        config passes the pod IP / hostname. ``tls`` (serving.tls.TlsConfig)
        secures all three surfaces; with require_client_auth peers must
        present certs signed by the configured CA. ``frontdoor_port``
        additionally binds the external surfaces on a SHARED
        SO_REUSEPORT listener so several worker processes on one host
        can serve one public port (multi-core scaling; must be a fixed
        port, not 0)."""
        if frontdoor_port is not None and frontdoor_port <= 0:
            # Ephemeral would give every worker a DIFFERENT port,
            # silently defeating the shared-listener design. Checked
            # before any server exists so failure leaks nothing.
            raise ValueError("frontdoor_port must be a fixed positive port")
        self.instance = instance
        self._advertise_host = advertise_host
        self.tls = tls
        # SO_REUSEPORT explicitly OFF here: the per-instance port must be
        # unique (peer forwards are addressed to exactly this process) —
        # gRPC's Linux default of reuseport=1 would let a copy-pasted
        # duplicate --port bind silently and split forwards between
        # workers. The shared front door below opts back in.
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers),
            options=message_size_options() + [("grpc.so_reuseport", 0)],
        )
        api_servicer = MeshApiServicer(instance, vmodels)
        fallback = InferenceFallback(
            instance, vmodels, payload_processor, dataplane
        )
        grpc_defs.add_servicer(
            self.server, api_servicer,
            grpc_defs.API_SERVICE, grpc_defs.API_METHODS,
        )
        grpc_defs.add_servicer(
            self.server, MeshInternalServicer(instance),
            grpc_defs.INTERNAL_SERVICE, grpc_defs.INTERNAL_METHODS,
        )
        self.server.add_generic_rpc_handlers(
            (grpc_defs.RawFallbackHandler(fallback),)
        )
        addr = f"{bind_host}:{port}"
        if tls is not None:
            self.port = self.server.add_secure_port(
                addr, tls.server_credentials()
            )
        else:
            self.port = self.server.add_insecure_port(addr)
        self.server.start()

        # Optional SHARED front door (multi-core hosts): N worker
        # processes on one host bind the SAME public port via
        # SO_REUSEPORT; the kernel balances incoming connections across
        # them and cache misses ride the normal internal Forward hop to
        # the owning worker. Only the EXTERNAL surfaces live here — the
        # per-instance port above stays unique so peer forwards reach
        # exactly this process. This is the framework's answer to the
        # Python GIL: scale the data plane with processes, not threads
        # (the reference scales one JVM with threads,
        # ModelMeshApi.java:649-819; a CPython port of that design would
        # serialize on the interpreter lock).
        self.frontdoor = None
        self.frontdoor_port = None
        if frontdoor_port is not None:
            # Same servicer/fallback OBJECTS as the internal listener:
            # one multi-model pool, one request-id sequence — two copies
            # would emit payload records with colliding req_ids.
            self.frontdoor = grpc.server(
                futures.ThreadPoolExecutor(max_workers),
                options=message_size_options() + [("grpc.so_reuseport", 1)],
            )
            grpc_defs.add_servicer(
                self.frontdoor, api_servicer,
                grpc_defs.API_SERVICE, grpc_defs.API_METHODS,
            )
            self.frontdoor.add_generic_rpc_handlers(
                (grpc_defs.RawFallbackHandler(fallback),)
            )
            fd_addr = f"{bind_host}:{frontdoor_port}"
            if tls is not None:
                self.frontdoor_port = self.frontdoor.add_secure_port(
                    fd_addr, tls.server_credentials()
                )
            else:
                self.frontdoor_port = self.frontdoor.add_insecure_port(fd_addr)
            if not self.frontdoor_port:
                # The internal server is already live — release it before
                # surfacing the failure or the caller has no handle left.
                self.server.stop(0)
                raise RuntimeError(
                    f"could not bind shared front door on {fd_addr}"
                )
            self.frontdoor.start()

    @property
    def endpoint(self) -> str:
        return f"{self._advertise_host}:{self.port}"

    def stop(self, grace: float = 0.5) -> None:
        if self.frontdoor is not None:
            self.frontdoor.stop(grace)
        self.server.stop(grace)


# -- client side --------------------------------------------------------------

class PeerChannels:
    """Channel cache for instance-to-instance calls (TLS-aware)."""

    def __init__(self, tls=None):
        self._channels: dict[str, grpc.Channel] = {}
        self._lock = threading.Lock()
        self._tls = tls

    def get(self, endpoint: str) -> grpc.Channel:
        with self._lock:
            ch = self._channels.get(endpoint)
            if ch is None:
                if self._tls is not None:
                    from modelmesh_tpu_torch.serving.tls import secure_channel

                    ch = secure_channel(endpoint, self._tls)
                else:
                    ch = grpc.insecure_channel(
                        endpoint, options=message_size_options()
                    )
                self._channels[endpoint] = ch
            return ch

    def close(self) -> None:
        with self._lock:
            for ch in self._channels.values():
                ch.close()
            self._channels.clear()


def make_grpc_peer_call(channels: Optional[PeerChannels] = None,
                        timeout_s: float = 30.0, tls=None):
    """Build the instance's peer transport over gRPC."""
    if channels is not None and tls is not None:
        raise ValueError(
            "pass tls to the PeerChannels cache, not alongside it — a "
            "caller-supplied cache keeps its own transport security"
        )
    channels = channels or PeerChannels(tls)

    def peer_call(
        endpoint: str, model_id: str, method: Optional[str], payload: bytes,
        headers: list[tuple[str, str]], ctx: RoutingContext,
    ) -> InvokeResult:
        stub = grpc_defs.make_stub(
            channels.get(endpoint), grpc_defs.INTERNAL_SERVICE,
            grpc_defs.INTERNAL_METHODS,
        )
        req = ipb.ForwardRequest(
            model_id=model_id,
            method_name=method or "",
            payload=payload,
            headers=dict(headers),
            ctx=_ctx_to_proto(ctx),
        )
        try:
            resp, trailers = grpc_defs.call_cancellable(
                stub.Forward, req, timeout=timeout_s,
                cancel_event=ctx.cancel_event, with_trailers=True,
            )
        except grpc.RpcError as e:
            detail = ""
            for k, v in (e.trailing_metadata() or ()):
                if k == ERROR_HEADER:
                    detail = v
            if detail == _ERR_NOT_HERE:
                raise ModelNotHereError(ctx.dest_instance, model_id) from e
            if detail == _ERR_NO_CAPACITY:
                raise NoCapacityError(e.details() or "") from e
            if detail == _ERR_LOAD_FAILED:
                raise ModelLoadException(e.details() or "load failed") from e
            if e.code() == grpc.StatusCode.NOT_FOUND:
                raise ModelNotFoundError(model_id) from e
            if e.code() in (
                grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.DEADLINE_EXCEEDED
            ):
                raise ServiceUnavailableError(endpoint) from e
            raise ApplierError(e.code().name, e.details() or "") from e
        status_name = {v: k for k, v in _STATUS_MAP.items()}.get(
            resp.model_status, "UNKNOWN"
        )
        # The mm-load trailer is the IMMEDIATE peer's report, so it is
        # attributed to the dialed instance (served_by may be a further
        # hop — not who our next pick would queue behind).
        feedback = None
        for k, v in trailers:
            if k == LOAD_HEADER:
                feedback = LoadFeedback.decode(ctx.dest_instance, v)
                break
        return InvokeResult(
            resp.payload, resp.served_by, status_name, feedback=feedback
        )

    peer_call.channels = channels  # for cleanup
    return peer_call


def make_grpc_peer_fetch(channels: Optional[PeerChannels] = None,
                         timeout_s: float = 30.0, tls=None):
    """Build the instance's weight-fetch transport over gRPC (the
    FetchWeights method beside Forward). Share the ``channels`` cache
    with ``make_grpc_peer_call`` so both internal surfaces multiplex one
    connection per peer."""
    from modelmesh_tpu_torch.transfer.protocol import FetchReply

    if channels is not None and tls is not None:
        raise ValueError(
            "pass tls to the PeerChannels cache, not alongside it — a "
            "caller-supplied cache keeps its own transport security"
        )
    channels = channels or PeerChannels(tls)

    def peer_fetch(endpoint: str, model_id: str, chunk_index: int,
                   fingerprint: str) -> FetchReply:
        stub = grpc_defs.make_stub(
            channels.get(endpoint), grpc_defs.INTERNAL_SERVICE,
            grpc_defs.INTERNAL_METHODS,
        )
        req = tpb.FetchWeightsRequest(
            model_id=model_id, chunk_index=chunk_index,
            fingerprint=fingerprint,
        )
        # Propagate the fetching load's trace context so the sender's
        # chunk-serving records join the receiver's trace tree.
        tid = Tracer.current_trace_id()
        md = (
            ((TRACE_HEADER, tid), (SPAN_HEADER, Tracer.current_span_id()))
            if tid else None
        )
        try:
            resp = stub.FetchWeights(req, timeout=timeout_s, metadata=md)
        except grpc.RpcError as e:
            # Transport-level failure (peer death, deadline): surfaced as
            # the mesh's unavailable error so the transfer manager's
            # mid-stream fallback takes over.
            raise ServiceUnavailableError(endpoint) from e
        return FetchReply(
            status=resp.status,
            payload=resp.payload,
            seq=resp.seq,
            layer=resp.layer,
            last=resp.last,
            total_chunks=resp.total_chunks,
            total_bytes=resp.total_bytes,
            total_layers=resp.total_layers,
            fingerprint=resp.fingerprint,
        )

    peer_fetch.channels = channels
    return peer_fetch
