"""The port's own copy of the JAX package's ``runtime/__init__.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Model-runtime SPI: loader interface, gRPC sidecar client, fake runtime."""

from modelmesh_tpu_torch.runtime.spi import (
    CACHE_UNIT_BYTES,
    LoadedModel,
    LocalInstanceParams,
    ModelInfo,
    ModelLoader,
    ModelLoadException,
)

__all__ = [
    "CACHE_UNIT_BYTES",
    "LoadedModel",
    "LocalInstanceParams",
    "ModelInfo",
    "ModelLoader",
    "ModelLoadException",
]
