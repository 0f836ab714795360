"""The port's own copy of the JAX package's ``native/__init__.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Native (C++) components with pure-Python fallbacks.

The compute path of the port is PyTorch/CUDA; the native layer covers the
runtime's hot byte-level paths — currently the protobuf splicer used by the
data plane for in-body model-id extraction. Binaries are built on demand
with g++ into ``_build/`` next to this package; absence of a toolchain
degrades gracefully to the Python implementations.
"""

from modelmesh_tpu_torch.native.proto_splicer import (
    backend,
    extract_id,
    splice_id,
)

__all__ = ["backend", "extract_id", "splice_id"]
