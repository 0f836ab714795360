"""The port's own copy of the JAX package's ``kv/__init__.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Coordination substrate: versioned KV, tables, sessions, leader election."""

from modelmesh_tpu_torch.kv.config import DynamicConfig
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
    "DynamicConfig",
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
