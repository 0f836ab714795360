"""The port's own copy of the JAX package's ``serving/errors.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Mesh routing/serving exceptions.

Mirrors the reference's exception protocol (modelmesh.thrift:42-84):
ModelNotHere drives retry-at-another-copy, ModelLoadException carries the
timeout flag, ApplierException wraps a downstream gRPC status.
"""

from __future__ import annotations

from modelmesh_tpu_torch.runtime.spi import ModelLoadException  # re-export

__all__ = [
    "ModelLoadException",
    "ModelNotFoundError",
    "ModelNotHereError",
    "NoCapacityError",
    "ApplierError",
    "OverloadShedError",
    "RequestCancelledError",
    "ServiceUnavailableError",
]


class ModelNotFoundError(Exception):
    """Model id is not in the registry."""


class ModelNotHereError(Exception):
    """The addressed instance doesn't (any longer) have the model copy."""

    def __init__(self, instance_id: str, model_id: str):
        super().__init__(f"model {model_id} not present on {instance_id}")
        self.instance_id = instance_id
        self.model_id = model_id


class NoCapacityError(Exception):
    """No instance can accept the load (cluster full / churn guard)."""


class ApplierError(Exception):
    """Downstream runtime returned a gRPC error for an inference call."""

    def __init__(self, grpc_code: str, message: str):
        super().__init__(f"{grpc_code}: {message}")
        self.grpc_code = grpc_code


class ReadOnlyModeError(Exception):
    """Registry mutation rejected: this instance runs in KV-migration
    read-only mode (MM_KV_READ_ONLY=1; reference readOnlyMode,
    ModelMesh.java:200-204) — model addition/removal is blocked while the
    operator migrates between disjoint KV stores."""


class ServiceUnavailableError(Exception):
    """Peer instance unreachable."""


class RequestCancelledError(Exception):
    """Client cancelled the request; abort in-flight work and free slots
    (reference cancellation propagation, ModelMeshApi.java:709-729)."""


class OverloadShedError(Exception):
    """Request deliberately shed by the admission controller
    (serving/admission.py): the class's token bucket was empty and the
    bounded queue window expired while higher-priority classes burn SLO
    budget. Typed so clients can distinguish 'the fleet chose not to
    serve you right now' (back off / retry elsewhere) from a failure —
    mapped to RESOURCE_EXHAUSTED with an mm-overload trailer at the API
    edge ("Load Balanced Demand Distribution under Overload Penalties",
    PAPERS.md: explicit shed penalties at the edge beat queue collapse
    fleet-wide)."""

    def __init__(self, model_class: str, message: str = ""):
        super().__init__(
            message or f"overload: class {model_class!r} shed at admission"
        )
        self.model_class = model_class
