"""The port's copies of the protocol's generated modules.

``mesh_runtime_pb2.py``, ``mesh_api_pb2.py``, ``mesh_internal_pb2.py``,
``mesh_transfer_pb2.py``, ``mesh_kv_pb2.py`` and ``etcd_rpc_pb2.py`` are
byte for byte the JAX package's (generated by protoc from
``protos/*.proto``): both register the same file descriptors, so they
load side by side in one process and their messages interoperate on the
wire. gRPC stubs and servicers are built from method maps in
``runtime/grpc_defs.py``.
"""

from modelmesh_tpu_torch.proto import (
    etcd_rpc_pb2,
    mesh_api_pb2,
    mesh_internal_pb2,
    mesh_kv_pb2,
    mesh_runtime_pb2,
    mesh_transfer_pb2,
)

__all__ = ["etcd_rpc_pb2", "mesh_api_pb2", "mesh_internal_pb2",
           "mesh_kv_pb2", "mesh_runtime_pb2", "mesh_transfer_pb2"]
