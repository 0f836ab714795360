"""The port's own copy of the JAX package's ``runtime/grpc_defs.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

gRPC service definitions built from method maps (no codegen plugin).

Provides stub/servicer factories for the three services (runtime SPI,
external management API, internal forwarding) plus the raw-bytes
identity marshallers used for arbitrary-method inference passthrough —
the equivalent of the reference's zero-copy ByteBuf method descriptors
(GrpcSupport.java:425-463, ModelMeshApi.java:649-819).
"""

from __future__ import annotations

from typing import Callable, Mapping, Type

import grpc

from modelmesh_tpu_torch.proto import (
    mesh_api_pb2,
    mesh_internal_pb2,
    mesh_runtime_pb2,
    mesh_transfer_pb2,
)

# Metadata keys carrying the model/vmodel id on inference calls
# (reference: GrpcSupport.java:110-126).
MODEL_ID_HEADER = "mm-model-id"
VMODEL_ID_HEADER = "mm-vmodel-id"

_MethodMap = Mapping[str, tuple[Type, Type]]

RUNTIME_SERVICE = "mmtpu.runtime.ModelRuntime"
RUNTIME_METHODS: _MethodMap = {
    "LoadModel": (
        mesh_runtime_pb2.LoadModelRequest, mesh_runtime_pb2.LoadModelResponse),
    "UnloadModel": (
        mesh_runtime_pb2.UnloadModelRequest, mesh_runtime_pb2.UnloadModelResponse),
    "PredictModelSize": (
        mesh_runtime_pb2.PredictModelSizeRequest, mesh_runtime_pb2.ModelSizeResponse),
    "ModelSize": (
        mesh_runtime_pb2.ModelSizeRequest, mesh_runtime_pb2.ModelSizeResponse),
    "RuntimeStatus": (
        mesh_runtime_pb2.RuntimeStatusRequest, mesh_runtime_pb2.RuntimeStatusResponse),
}

API_SERVICE = "mmtpu.api.ModelMesh"
API_METHODS: _MethodMap = {
    "RegisterModel": (
        mesh_api_pb2.RegisterModelRequest, mesh_api_pb2.ModelStatusInfo),
    "UnregisterModel": (
        mesh_api_pb2.UnregisterModelRequest, mesh_api_pb2.UnregisterModelResponse),
    "GetModelStatus": (
        mesh_api_pb2.GetModelStatusRequest, mesh_api_pb2.ModelStatusInfo),
    "EnsureLoaded": (
        mesh_api_pb2.EnsureLoadedRequest, mesh_api_pb2.ModelStatusInfo),
    "SetVModel": (
        mesh_api_pb2.SetVModelRequest, mesh_api_pb2.VModelStatusInfo),
    "DeleteVModel": (
        mesh_api_pb2.DeleteVModelRequest, mesh_api_pb2.DeleteVModelResponse),
    "GetVModelStatus": (
        mesh_api_pb2.GetVModelStatusRequest, mesh_api_pb2.VModelStatusInfo),
}

INTERNAL_SERVICE = "mmtpu.internal.MeshInternal"
INTERNAL_METHODS: _MethodMap = {
    "Forward": (
        mesh_internal_pb2.ForwardRequest, mesh_internal_pb2.ForwardResponse),
    # Weight-transfer fetch (live scale-up): chunk-indexed peer pull of a
    # model's weight snapshot, served beside Forward on the internal port.
    "FetchWeights": (
        mesh_transfer_pb2.FetchWeightsRequest,
        mesh_transfer_pb2.FetchWeightsResponse),
}


def make_stub(channel: grpc.Channel, service: str, methods: _MethodMap):
    """Build a stub object with one unary-unary callable per method."""

    class _Stub:
        pass

    stub = _Stub()
    for name, (req_cls, resp_cls) in methods.items():
        setattr(
            stub,
            name,
            channel.unary_unary(
                f"/{service}/{name}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString,
            ),
        )
    return stub


def add_servicer(
    server: grpc.Server, servicer: object, service: str, methods: _MethodMap
) -> None:
    """Register ``servicer`` (which has a method per RPC name) on a server."""
    handlers = {}
    for name, (req_cls, resp_cls) in methods.items():
        fn = getattr(servicer, name)
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service, handlers),)
    )


# -- raw-bytes passthrough ----------------------------------------------------

def _identity(b: bytes) -> bytes:
    return b


def raw_method(channel: grpc.Channel, full_method: str):
    """Client callable for an arbitrary method with opaque byte payloads."""
    return channel.unary_unary(
        full_method, request_serializer=_identity, response_deserializer=_identity
    )


class RawFallbackHandler(grpc.GenericRpcHandler):
    """Server-side catch-all: any unregistered unary method is delivered to
    ``handler(method_name, request_bytes, context) -> response_bytes``.

    This is how arbitrary inference RPCs enter the mesh without registering
    per-method descriptors (reference fallback Registry,
    ModelMeshApi.java:1099-1160).
    """

    def __init__(self, handler: Callable[[str, bytes, grpc.ServicerContext], bytes]):
        self._handler = handler

    def service(self, handler_call_details):
        method = handler_call_details.method

        def unary(request: bytes, context: grpc.ServicerContext) -> bytes:
            return self._handler(method, request, context)

        return grpc.unary_unary_rpc_method_handler(
            unary, request_deserializer=_identity, response_serializer=_identity
        )


def call_cancellable(callable_, request, timeout=None, metadata=None,
                     cancel_event=None, with_trailers=False):
    """Invoke a unary-unary multicallable, aborting early when
    ``cancel_event`` fires (client disconnect): the in-flight RPC is
    cancelled so the remote side's context deactivates too, and the local
    concurrency slot frees immediately instead of riding out the call.

    ``with_trailers=True`` returns ``(response, trailing_metadata)`` so
    callers can read piggybacked response trailers (the Forward path's
    mm-load feedback) without a second RPC surface."""
    if cancel_event is None:
        if with_trailers:
            resp, call = callable_.with_call(
                request, timeout=timeout, metadata=metadata
            )
            return resp, call.trailing_metadata() or ()
        return callable_(request, timeout=timeout, metadata=metadata)
    import threading

    from modelmesh_tpu_torch.serving.errors import RequestCancelledError

    fut = callable_.future(request, timeout=timeout, metadata=metadata)
    done = threading.Event()
    fut.add_done_callback(lambda _f: done.set())
    while not done.wait(0.05):  #: wall-clock: polls a REAL in-flight gRPC future at cancel-check cadence
        if cancel_event.is_set():
            fut.cancel()
            raise RequestCancelledError("client disconnected")
    result = fut.result()
    if with_trailers:
        # The rendezvous future is also the Call: trailers are available
        # once the result is.
        return result, fut.trailing_metadata() or ()
    return result


def bind_server(server, port: int = 0, bind_host: str = "127.0.0.1",
                uds_path: str = "") -> int:
    """Bind a grpc.Server to TCP or a unix socket; returns the bound TCP
    port (0 for UDS). A failed unix bind raises instead of the silent
    0-return grpc gives."""
    if uds_path:
        if server.add_insecure_port(f"unix://{uds_path}") == 0:
            raise RuntimeError(f"failed to bind unix socket {uds_path}")
        return 0
    return server.add_insecure_port(f"{bind_host}:{port}")
