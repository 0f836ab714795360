"""The port's own copy of the JAX package's ``autoscale/__init__.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Autoscale subsystem: burn-rate-driven copy scaling + predictive
pre-warming (see controller.py for the full design note)."""

from modelmesh_tpu_torch.autoscale.controller import (
    AutoscaleConfig,
    AutoscaleController,
    MODES,
    prewarm_plan_key,
)
from modelmesh_tpu_torch.autoscale.forecast import DemandForecaster

__all__ = [
    "AutoscaleConfig",
    "AutoscaleController",
    "DemandForecaster",
    "MODES",
    "prewarm_plan_key",
]
