"""Coordination substrate: versioned KV, tables, sessions, leader election.

The port's own copy of the JAX package's ``kv/`` exports, without
``DynamicConfig`` (``kv/config.py`` is not ported yet).
"""

from modelmesh_tpu_torch.kv.memory import InMemoryKV
from modelmesh_tpu_torch.kv.session import LeaderElection, SessionNode
from modelmesh_tpu_torch.kv.store import (
    CasFailed,
    Compare,
    EventType,
    KeyValue,
    KVStore,
    Op,
    WatchEvent,
)
from modelmesh_tpu_torch.kv.table import (
    KVTable,
    Record,
    TableEvent,
    TableView,
)

__all__ = [
    "InMemoryKV",
    "LeaderElection",
    "SessionNode",
    "CasFailed",
    "Compare",
    "EventType",
    "KeyValue",
    "KVStore",
    "Op",
    "WatchEvent",
    "KVTable",
    "Record",
    "TableEvent",
    "TableView",
]
