"""Placement strategies: the SPI, the greedy fallback, and the global
solver on the card (``torch_engine.py``)."""

from modelmesh_tpu_torch.placement.greedy import GreedyStrategy
from modelmesh_tpu_torch.placement.strategy import (
    LOAD_HERE,
    ClusterView,
    PlacementRequest,
    PlacementStrategy,
)

__all__ = [
    "GreedyStrategy",
    "LOAD_HERE",
    "ClusterView",
    "PlacementRequest",
    "PlacementStrategy",
]
