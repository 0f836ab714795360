"""The port's own copy of the JAX package's ``kv/store.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

KV store abstraction — the coordination substrate interface.

Capability-equivalent to the surface of the reference's (external) kv-utils
library as used by the serving core (SURVEY.md section 2: KVTable/TableView,
SessionNode leases, LeaderElection, DynamicConfig; usage at
ModelMesh.java:582-628, 783-825): versioned CAS, prefix range/watch,
TTL leases with ephemeral keys, transactions.

The model follows etcd3 semantics (global revision, per-key create/mod
revision + version counter, lease ids) so an etcd-backed implementation can
slot in without changing callers; tests and single-host clusters use the
in-memory / gRPC-served implementations.
"""

from __future__ import annotations

import abc
import dataclasses
import enum
from typing import Callable, Iterable, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class KeyValue:
    key: str
    value: bytes
    create_rev: int    # revision at which the key was created
    mod_rev: int       # revision of the last modification
    version: int       # per-key modification counter (1 on create)
    lease: int = 0     # owning lease id, 0 = none


class EventType(enum.Enum):
    PUT = "put"
    DELETE = "delete"


@dataclasses.dataclass(frozen=True)
class WatchEvent:
    type: EventType
    kv: KeyValue                      # for DELETE: last-seen kv (value b"")
    prev: Optional[KeyValue] = None


WatchCallback = Callable[[Sequence[WatchEvent]], None]


class WatchHandle(abc.ABC):
    @abc.abstractmethod
    def cancel(self) -> None: ...


@dataclasses.dataclass(frozen=True)
class Compare:
    """Transaction guard: compare a key's version (etcd-style).

    version == 0 asserts the key does NOT exist.
    """

    key: str
    version: int


@dataclasses.dataclass(frozen=True)
class Op:
    """Transaction mutation: put (value is not None) or delete."""

    key: str
    value: Optional[bytes] = None
    lease: int = 0


class CasFailed(Exception):
    """Conditional update lost the race; reread and retry."""


class CompactedRevision(Exception):
    """Historical read below the compaction floor (etcd ErrCompacted)."""

    def __init__(self, requested: int, floor: int):
        super().__init__(
            f"revision {requested} has been compacted (floor {floor})"
        )
        self.requested = requested
        self.floor = floor


class FutureRevision(Exception):
    """Historical read above the current revision (etcd ErrFutureRev)."""

    def __init__(self, requested: int, current: int):
        super().__init__(
            f"revision {requested} is a future revision (current {current})"
        )
        self.requested = requested
        self.current = current


class KVStore(abc.ABC):
    """Versioned KV with prefix watch, leases, and transactions."""

    # -- reads ------------------------------------------------------------

    @abc.abstractmethod
    def get(self, key: str) -> Optional[KeyValue]: ...

    @abc.abstractmethod
    def range(self, prefix: str) -> list[KeyValue]: ...

    def range_from(
        self, prefix: str, start_key: str, limit: int
    ) -> list[KeyValue]:
        """Up to ``limit`` keys under ``prefix`` with key >= ``start_key``,
        sorted. The pagination primitive behind range_paged; backends
        override with a server-side limited read (base impl slices a full
        range — correct but unbounded on the wire)."""
        kvs = [kv for kv in self.range(prefix) if kv.key >= start_key]
        return kvs[:limit]

    def range_paged(self, prefix: str, page_size: int = 1000):
        """Stream a prefix in bounded pages (generator of KeyValue).

        At registry scale (100k+ records) a single range() response blows
        the 16 MiB message cap and holds tens of MB of protos at once;
        start-key pagination keeps every RPC and the client's working set
        bounded. Not a snapshot: concurrent writes may or may not appear,
        like iterating a live dict.
        """
        start = prefix
        while True:
            page = self.range_from(prefix, start, page_size)
            yield from page
            if len(page) < page_size:
                return
            start = page[-1].key + "\x00"

    # -- writes -----------------------------------------------------------

    @abc.abstractmethod
    def put(self, key: str, value: bytes, lease: int = 0) -> KeyValue: ...

    def put_if_version(
        self, key: str, value: bytes, expected_version: int, lease: int = 0
    ) -> KeyValue:
        """CAS put: succeeds only if the key's version matches (0 = absent).

        Raises CasFailed otherwise. Default implementation via txn().
        """
        ok, _ = self.txn(
            [Compare(key, expected_version)], [Op(key, value, lease)], []
        )
        if not ok:
            raise CasFailed(key)
        kv = self.get(key)
        assert kv is not None
        return kv

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...

    def delete_if_version(self, key: str, expected_version: int) -> bool:
        ok, _ = self.txn([Compare(key, expected_version)], [Op(key)], [])
        return ok

    @abc.abstractmethod
    def txn(
        self,
        compares: Iterable[Compare],
        on_success: Iterable[Op],
        on_failure: Iterable[Op] = (),
    ) -> tuple[bool, list[KeyValue]]:
        """Atomic multi-key conditional mutation (etcd txn semantics)."""

    # -- watch ------------------------------------------------------------

    @abc.abstractmethod
    def watch(
        self,
        prefix: str,
        callback: WatchCallback,
        start_rev: Optional[int] = None,
    ) -> WatchHandle:
        """Subscribe to changes under a prefix.

        ``start_rev``: deliver events with mod_rev > start_rev that occurred
        before subscription (replay), then stream. None = only new events.
        """

    # -- leases -----------------------------------------------------------

    @abc.abstractmethod
    def lease_grant(self, ttl_s: float) -> int: ...

    @abc.abstractmethod
    def lease_keepalive(self, lease_id: int) -> bool:
        """Refresh; returns False if the lease no longer exists."""

    @abc.abstractmethod
    def lease_revoke(self, lease_id: int) -> None:
        """Drop the lease and delete all attached keys."""

    # -- limits -----------------------------------------------------------

    def max_value_bytes(self) -> Optional[int]:
        """Largest value this backend can store (None = unbounded).

        Writers of potentially-large values (plan publication) size their
        artifacts against this instead of discovering RESOURCE_EXHAUSTED at
        put time.
        """
        return None

    def check_value_size(self, value: bytes) -> None:
        """Raise ValueError when ``value`` exceeds max_value_bytes()."""
        limit = self.max_value_bytes()
        if limit is not None and len(value) > limit:
            raise ValueError(
                f"value of {len(value)} bytes exceeds this store's limit "
                f"of {limit} bytes"
            )

    # -- lifecycle ---------------------------------------------------------

    @abc.abstractmethod
    def close(self) -> None: ...

    # -- test support -------------------------------------------------------

    def wait_idle(self, timeout: float = 5.0) -> None:
        """Best-effort barrier for watch-event delivery (test helper).
        In-process stores drain their dispatch queue; networked stores can
        only allow propagation time."""
        import time as _time

        _time.sleep(0.25)  #: wall-clock: test helper allowing REAL wire/dispatcher propagation; virtual time cannot advance a network
