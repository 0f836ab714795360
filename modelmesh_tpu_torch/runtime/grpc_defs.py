"""gRPC definitions of the model-runtime service, built from a method map.

The port's copy of the runtime half of the JAX package's
``runtime/grpc_defs.py``: the ``ModelRuntime`` service's method map, the
stub and servicer factories, and the raw-bytes identity marshallers that
carry inference payloads for any method name (the reference's fallback
registry, ModelMeshApi.java:1099-1160). Names, paths and wire formats are
the reference's, so either side of a connection may be either package.
"""

from __future__ import annotations

from typing import Callable, Mapping, Type

import grpc

from modelmesh_tpu_torch.proto import mesh_runtime_pb2

# Metadata key carrying the model id on inference calls
# (reference: GrpcSupport.java:110-126).
MODEL_ID_HEADER = "mm-model-id"

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
    ``handler(method_name, request_bytes, context) -> response_bytes``."""

    def __init__(self, handler: Callable[[str, bytes, grpc.ServicerContext], bytes]):
        self._handler = handler

    def service(self, handler_call_details):
        method = handler_call_details.method

        def unary(request: bytes, context: grpc.ServicerContext) -> bytes:
            return self._handler(method, request, context)

        return grpc.unary_unary_rpc_method_handler(
            unary, request_deserializer=_identity, response_serializer=_identity
        )


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
