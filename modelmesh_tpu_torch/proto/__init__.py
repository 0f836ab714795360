"""The port's copy of the runtime protocol's generated module.

``mesh_runtime_pb2.py`` is byte for byte the JAX package's (generated by
protoc from ``protos/mesh_runtime.proto``): both register the same file
descriptor, so they load side by side in one process and their messages
interoperate on the wire.
"""
