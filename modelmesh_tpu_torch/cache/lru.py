"""The port's own copy of the JAX package's ``cache/lru.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Weighted, timestamp-ordered LRU cache — the per-instance model cache.

Equivalent in capability to the reference's vendored ConcurrentLinkedHashMap
fork (MM/clhm/ConcurrentLinkedHashMap.java): a weighted-capacity map ordered
by *explicit* last-used timestamps rather than access order alone, because
the serving layer backdates entries (e.g. newly registered models are
inserted with lastUsed an hour in the past, ModelMesh.java:3097-3147) and
force-refreshes timestamps from the shared registry.

Capabilities mirrored (reference methods cited for parity checking):
- put_if_absent(key, value, weight, last_used)     (clhm putIfAbsent :806)
- get(..) touching now / get_quietly(..) no touch  (:742, getQuietly :784)
- last_used(key) / force_last_used(key, ts)        (getLastUsedTime :742,
                                                    forceSetLastUsedTime :751)
- replace_quietly(key, old, new)                   (replaceQuietly :960)
- oldest_time()                                    (oldestTime :1125)
- descending_items() newest->oldest               (descendingLruMap :1087)
- items_used_since(cutoff) newest->oldest         (descendingMapWithCutoff :1226)
- weighted capacity + eviction listener dispatched under the eviction lock
  with the evicted entry's timestamp                (EvictionListenerWithTime
                                                    :1816, dispatch :582-583)
- exposed eviction lock for unload-buffer accounting (getEvictionLock :283)
- update_weight(key, new_weight) re-accounting      (weight adjust on sizing)

Implementation notes: Python-side we keep a dict of entries plus a lazy
min-heap on (last_used, seq) for eviction order; stale heap nodes are
skipped on pop. All mutation happens under a single re-entrant lock which
is *the* eviction lock the unload-buffer manager shares, mirroring the
reference's design where unload accounting runs under the CLHM eviction
lock (ModelCacheUnloadBufManager.java:51-54).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Callable, Generic, Iterator, Optional, TypeVar

# Re-exported time source: most of the serving layer imports now_ms from
# here; routing it through the injectable clock (utils/clock.py) puts the
# whole LRU/lifecycle timestamp domain under simulated virtual time.
from modelmesh_tpu_torch.utils.clock import now_ms  # noqa: F401 — re-export
from modelmesh_tpu_torch.utils.lockdebug import mm_lock, mm_rlock

K = TypeVar("K")
V = TypeVar("V")

# listener(key, value, last_used_ms) — called under the eviction lock.
EvictionListener = Callable[[Any, Any, int], None]


@dataclass
class _Entry(Generic[V]):
    value: V
    weight: int
    last_used: int
    seq: int              # tie-break for equal timestamps (insertion order)
    heap_stale: bool = field(default=False)  # true if heap node is outdated


class WeightedLRUCache(Generic[K, V]):
    """Thread-safe weighted LRU with out-of-band timestamps."""

    def __init__(
        self,
        capacity: int,
        eviction_listener: Optional[EvictionListener] = None,
    ) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._capacity = capacity  #: guarded-by: _lock
        self._listener = eviction_listener
        self._entries: dict[K, _Entry[V]] = {}  #: guarded-by: _lock
        #: guarded-by: _lock
        self._heap: list[tuple[int, int, K]] = []  # (last_used, seq, key)
        self._weight = 0  #: guarded-by: _lock
        self._seq = 0  #: guarded-by: _lock
        self._lock = mm_rlock("WeightedLRUCache._lock")

    # -- locking ----------------------------------------------------------

    @property
    def eviction_lock(self):
        """The lock all mutation runs under (a ``threading.RLock``, or
        its MM_LOCK_DEBUG wrapper); shared with unload accounting."""
        return self._lock

    # -- capacity ---------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._capacity

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._capacity = capacity
            self._evict_over_capacity_locked()

    @property
    def weight(self) -> int:
        return self._weight

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: K) -> bool:
        return key in self._entries

    # -- core ops ---------------------------------------------------------

    def put_if_absent(
        self, key: K, value: V, weight: int, last_used: Optional[int] = None
    ) -> Optional[V]:
        """Insert unless present; returns the existing value if present.

        ``last_used`` may be in the past (backdated registration) or future.
        Insertion may synchronously evict other entries (never the new one,
        unless it alone exceeds capacity — then it is rejected by raising
        ``ValueError``, mirroring the reference's pathological-size refusal
        at ModelMesh.java:2172-2196 which is handled a level up).
        """
        ts = now_ms() if last_used is None else last_used
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                return existing.value
            if weight > self._capacity:
                raise ValueError(
                    f"entry weight {weight} exceeds cache capacity "
                    f"{self._capacity}"
                )
            self._seq += 1
            entry = _Entry(value=value, weight=weight, last_used=ts, seq=self._seq)
            self._entries[key] = entry
            self._weight += weight
            heapq.heappush(self._heap, (ts, entry.seq, key))
            self._evict_over_capacity_locked(exclude=key)
            return None

    def get(self, key: K, touch_ts: Optional[int] = None) -> Optional[V]:
        """Lookup, refreshing the entry's last-used timestamp."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            self._touch_locked(key, entry, now_ms() if touch_ts is None else touch_ts)
            return entry.value

    def get_quietly(self, key: K) -> Optional[V]:
        """Lookup without disturbing LRU order (reference getQuietly)."""
        entry = self._entries.get(key)
        return None if entry is None else entry.value

    def replace_quietly(self, key: K, old_value: V, new_value: V) -> bool:
        """CAS the value without touching LRU order."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.value is not old_value:
                return False
            entry.value = new_value
            return True

    def remove(self, key: K) -> Optional[V]:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return None
            self._weight -= entry.weight
            return entry.value

    def remove_if_value(self, key: K, value: V) -> bool:
        """Remove only if the mapped value is identical (CAS-remove)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.value is not value:
                return False
            del self._entries[key]
            self._weight -= entry.weight
            return True

    # -- timestamps -------------------------------------------------------

    def last_used(self, key: K) -> Optional[int]:
        entry = self._entries.get(key)
        return None if entry is None else entry.last_used

    def force_last_used(self, key: K, ts: int) -> bool:
        """Set an entry's timestamp (may move it either direction)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return False
            self._touch_locked(key, entry, ts, force=True)
            return True

    def oldest_time(self) -> Optional[int]:
        """Timestamp of the least-recently-used entry, None if empty."""
        with self._lock:
            while self._heap:
                ts, seq, key = self._heap[0]
                entry = self._entries.get(key)
                if entry is None or entry.seq != seq or entry.last_used != ts:
                    heapq.heappop(self._heap)  # stale node
                    continue
                return ts
            return None

    # -- weight updates ---------------------------------------------------

    def update_weight(self, key: K, new_weight: int) -> Optional[int]:
        """Re-account an entry's weight (model sizing). Returns old weight.

        Growing an entry may evict others (never the updated entry itself).
        """
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            old = entry.weight
            entry.weight = new_weight
            self._weight += new_weight - old
            if new_weight > old:
                self._evict_over_capacity_locked(exclude=key)
            return old

    def update_weight_if_value(
        self, key: K, value: V, new_weight: int
    ) -> bool:
        """CAS-style ``update_weight``: re-account only while ``key`` still
        maps to this exact ``value``. The serve-before-sizing correction
        uses this so a stale sizing follow-up can never re-weigh a
        replacement copy inserted after its entry was evicted."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.value is not value:
                return False
            old = entry.weight
            entry.weight = new_weight
            self._weight += new_weight - old
            if new_weight > old:
                self._evict_over_capacity_locked(exclude=key)
            return True

    # -- iteration --------------------------------------------------------

    def descending_items(self) -> Iterator[tuple[K, V, int]]:
        """(key, value, last_used) newest -> oldest. Snapshot iteration."""
        with self._lock:
            snapshot = sorted(
                ((e.last_used, e.seq, k, e.value) for k, e in self._entries.items()),
                reverse=True,
            )
        for ts, _seq, k, v in snapshot:
            yield k, v, ts

    def items_used_since(self, cutoff: int) -> Iterator[tuple[K, V, int]]:
        """Entries with last_used >= cutoff, newest -> oldest."""
        for k, v, ts in self.descending_items():
            if ts < cutoff:
                return
            yield k, v, ts

    def ascending_items(self) -> Iterator[tuple[K, V, int]]:
        """(key, value, last_used) oldest -> newest. Snapshot iteration."""
        items = list(self.descending_items())
        return iter(items[::-1])

    def keys(self):
        return list(self._entries.keys())

    # -- internals --------------------------------------------------------

    def _touch_locked(self, key: K, entry: _Entry[V], ts: int, force: bool = False) -> None:
        if not force and ts <= entry.last_used:
            return  # never move an entry backwards on plain access
        entry.last_used = ts
        heapq.heappush(self._heap, (ts, entry.seq, key))

    def _evict_over_capacity_locked(self, exclude: Optional[K] = None) -> None:
        """Pop LRU entries until within capacity. Caller holds the lock."""
        while self._weight > self._capacity and self._entries:
            victim = self._pop_lru_locked(exclude)
            if victim is None:
                return  # only the excluded entry remains
            key, entry = victim
            del self._entries[key]
            self._weight -= entry.weight
            if self._listener is not None:
                self._listener(key, entry.value, entry.last_used)

    def _pop_lru_locked(self, exclude: Optional[K]) -> Optional[tuple[K, _Entry[V]]]:
        skipped: Optional[tuple[int, int, K]] = None
        while self._heap:
            ts, seq, key = heapq.heappop(self._heap)
            entry = self._entries.get(key)
            if entry is None or entry.seq != seq or entry.last_used != ts:
                continue  # stale
            if key == exclude:
                skipped = (ts, seq, key)
                continue
            if skipped is not None:
                heapq.heappush(self._heap, skipped)
            return key, entry
        if skipped is not None:
            heapq.heappush(self._heap, skipped)
        return None


# listener(key, value, size_bytes) — called under the host-tier lock; must
# not block (schedule follow-up work, like the device eviction listener).
HostEvictionListener = Callable[[Any, Any, int], None]


class HostTier(Generic[K, V]):
    """Host-RAM staging tier under the device cache: the demote target.

    Device eviction demotes a copy's serialized weights here instead of
    dropping them entirely, so a re-warm is a host->device copy (and a
    peer fetch can be served O(1) from host RAM) rather than a model-store
    load — the BLITZSCALE tiered-caching layer. Accounting is in BYTES
    and entirely separate from the device cache's unit accounting:
    ``used_bytes <= capacity_bytes`` always, with LRU eviction by
    last-touch time on insert pressure. ``capacity_bytes <= 0`` disables
    the tier (every put is rejected).

    Values are opaque to the tier (the transfer layer stores serialized
    chunk snapshots); ``get`` touches recency, ``peek`` doesn't — the
    same quiet/touch split as the device cache above.
    """

    def __init__(
        self,
        capacity_bytes: int,
        eviction_listener: Optional[HostEvictionListener] = None,
    ) -> None:
        self._capacity = max(int(capacity_bytes), 0)
        self._listener = eviction_listener
        # key -> (value, size_bytes, last_used, seq)
        self._copies: dict[K, list] = {}  #: guarded-by: _lock
        self._used = 0  #: guarded-by: _lock
        self._seq = 0  #: guarded-by: _lock
        self._lock = mm_lock("HostTier._lock")

    @property
    def enabled(self) -> bool:
        return self._capacity > 0

    @property
    def capacity_bytes(self) -> int:
        return self._capacity

    @property
    def used_bytes(self) -> int:
        return self._used

    def __len__(self) -> int:
        return len(self._copies)

    def __contains__(self, key: K) -> bool:
        return key in self._copies

    def keys(self) -> list[K]:
        return list(self._copies.keys())

    def _insert_locked(self, key: K, value: V, size_bytes: int) -> None:
        """Reclaim any same-key entry, then insert with fresh recency.
        ONE implementation of the entry layout/accounting shared by
        both insert policies below. Caller holds the lock."""
        prev = self._copies.pop(key, None)
        if prev is not None:
            self._used -= prev[1]
        self._seq += 1
        self._copies[key] = [value, size_bytes, now_ms(), self._seq]
        self._used += size_bytes

    def put(self, key: K, value: V, size_bytes: int) -> bool:
        """Insert/replace a host copy; False when the tier is disabled or
        the copy alone exceeds the host budget (caller falls back to a
        plain drop — demotion is best-effort by design). Insertion may
        evict older host copies (never the new one)."""
        size_bytes = int(size_bytes)
        if size_bytes <= 0 or size_bytes > self._capacity:
            return False
        with self._lock:
            self._insert_locked(key, value, size_bytes)
            self._evict_over_capacity_locked(exclude=key)
            return True

    def put_if_room(self, key: K, value: V, size_bytes: int) -> bool:
        """Speculative insert (the autoscale pre-warm hook): accepted
        only when the copy fits the FREE budget — a forecast-driven
        pre-warm must never evict a demoted snapshot, whose presence is
        a certainty (that copy existed) rather than a prediction.
        Replacing an existing snapshot for the same key is allowed (its
        bytes are reclaimed first, so no third copy is displaced)."""
        size_bytes = int(size_bytes)
        if size_bytes <= 0 or size_bytes > self._capacity:
            return False
        with self._lock:
            prev = self._copies.get(key)
            freed = prev[1] if prev is not None else 0
            if self._used - freed + size_bytes > self._capacity:
                return False
            self._insert_locked(key, value, size_bytes)
            return True

    def get(self, key: K) -> Optional[V]:
        """Lookup, refreshing recency (a re-warm / peer-fetch source hit).
        The sequence bumps with the timestamp so same-millisecond touches
        still order exactly (ms granularity is coarser than transfers)."""
        with self._lock:
            entry = self._copies.get(key)
            if entry is None:
                return None
            self._seq += 1
            entry[2] = now_ms()
            entry[3] = self._seq
            return entry[0]

    def peek(self, key: K) -> Optional[V]:
        entry = self._copies.get(key)
        return None if entry is None else entry[0]

    def size_of(self, key: K) -> int:
        entry = self._copies.get(key)
        return 0 if entry is None else entry[1]

    def remove(self, key: K) -> Optional[V]:
        with self._lock:
            entry = self._copies.pop(key, None)
            if entry is None:
                return None
            self._used -= entry[1]
            return entry[0]

    def clear(self) -> None:
        with self._lock:
            self._copies.clear()
            self._used = 0

    def _evict_over_capacity_locked(self, exclude: Optional[K] = None) -> None:
        while self._used > self._capacity and self._copies:
            victims = [
                (e[2], e[3], k)
                for k, e in self._copies.items() if k != exclude
            ]
            if not victims:
                return  # only the excluded entry remains
            _, _, victim = min(victims)
            value, size, _, _ = self._copies.pop(victim)
            self._used -= size
            if self._listener is not None:
                self._listener(victim, value, size)
