"""The port's own copy of the JAX package's ``kv/memory.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

In-memory KVStore with full etcd-style semantics.

Used directly by unit tests and wrapped by the gRPC KV service
(kv/service.py) for multi-process cluster tests — mirroring how the
reference tests run against a real etcd child process
(AbstractModelMeshTest.java:83-192) without requiring etcd in the image.

Watch events are dispatched on a dedicated thread so callbacks may freely
re-enter the store. Lease expiry runs on a sweeper thread; expired leases
delete their attached keys and emit DELETE events (ephemeral-node semantics
for instance liveness, reference: SessionNode usage at ModelMesh.java:788).
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
from typing import Iterable, Optional, Sequence

from modelmesh_tpu_torch.kv.store import (
    Compare,
    CompactedRevision,
    EventType,
    FutureRevision,
    KeyValue,
    KVStore,
    Op,
    WatchCallback,
    WatchEvent,
    WatchHandle,
)
from modelmesh_tpu_torch.utils import clock as _clock


class _Watcher(WatchHandle):
    def __init__(self, store: "InMemoryKV", prefix: str, callback: WatchCallback):
        self.prefix = prefix
        self.callback = callback
        self._store = store
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True
        with self._store._lock:
            self._store._watchers.discard(self)


class InMemoryKV(KVStore):
    def __init__(self, sweep_interval_s: float = 0.1, history_cap: int = 8192):
        # Lease deadlines and the expiry sweeper follow the clock installed
        # at construction: under the simulation's VirtualClock, TTLs expire
        # in virtual time (ephemeral-node semantics the scenario engine can
        # compress or jump across).
        self._clock = _clock.get_clock()
        self._lock = threading.RLock()
        self._data: dict[str, KeyValue] = {}
        self._rev = 0
        self._lease_seq = itertools.count(1)
        # lease_id -> (deadline_monotonic, ttl_s, set[key])
        self._leases: dict[int, tuple[float, float, set[str]]] = {}
        self._watchers: set[_Watcher] = set()
        self._events: "queue.Queue" = queue.Queue()
        # clock-aware event: set() wakes a virtual-time sweeper wait too.
        self._closed = self._clock.new_event()
        # Bounded replay history (etcd compaction analog): a long-running
        # MeshKV process must not grow memory with total write count.
        # Events at or below _compact_rev are unavailable for replay;
        # watches starting below the floor get a full-state fallback.
        self._history: list[WatchEvent] = []
        self._history_cap = max(16, history_cap)
        self._compact_rev = 0
        # Sorted key index for range_from, keyed on a MUTATION counter
        # (not the revision — batched writes reuse one revision, so _rev
        # cannot uniquely identify keyspace state).
        self._sorted_keys: list[str] = []
        self._sorted_keys_mut = -1
        self._mutations = 0
        # Revision batching (etcd txn semantics): all writes inside one
        # batch() share a single global revision — real etcd stamps every
        # op of a txn / DeleteRange / lease-revoke with ONE revision, and
        # clients fence on txn header revisions.
        self._batch_depth = 0
        self._batch_rev_allocated = False
        # Events produced inside a batch buffer here and flush as ONE
        # delivery per watcher at batch exit: resume fencing everywhere is
        # strictly-greater on mod_rev, so splitting same-revision events
        # across deliveries would let a mid-batch disconnect permanently
        # drop the tail (etcd ships one revision as one WatchResponse).
        self._batch_events: list[WatchEvent] = []
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="kv-dispatch", daemon=True
        )
        self._dispatcher.start()
        self._sweeper = threading.Thread(
            target=self._sweep_loop,
            args=(sweep_interval_s,),
            name="kv-lease-sweeper",
            daemon=True,
        )
        self._sweeper.start()

    # -- reads ------------------------------------------------------------

    def get(self, key: str) -> Optional[KeyValue]:
        with self._lock:
            return self._data.get(key)

    def range(self, prefix: str) -> list[KeyValue]:
        with self._lock:
            return sorted(
                (kv for k, kv in self._data.items() if k.startswith(prefix)),
                key=lambda kv: kv.key,
            )

    def range_from(self, prefix: str, start_key: str, limit: int) -> list[KeyValue]:
        # Bisect over a mutation-cached sorted key index: paged scans (the
        # bucketed registry issues >=128 of these per full iteration, and
        # janitor cycles repeat them) must not re-scan and re-sort the
        # whole keyspace per page.
        import bisect

        with self._lock:
            if self._sorted_keys_mut != self._mutations:
                self._sorted_keys = sorted(self._data)
                self._sorted_keys_mut = self._mutations
            keys = self._sorted_keys
            i = bisect.bisect_left(keys, max(start_key, prefix))
            out = []
            while i < len(keys) and len(out) < limit:
                k = keys[i]
                if not k.startswith(prefix):
                    break  # sorted + start>=prefix: past the prefix block
                out.append(self._data[k])
                i += 1
            return out

    def range_interval(self, start: str, end: str) -> list[KeyValue]:
        """Keys in [start, end) — etcd Range semantics; end "" = exact key."""
        with self._lock:
            if not end:
                kv = self._data.get(start)
                return [kv] if kv else []
            return sorted(
                (kv for k, kv in self._data.items() if start <= k < end),
                key=lambda kv: kv.key,
            )

    @property
    def revision(self) -> int:
        with self._lock:
            return self._rev

    def snapshot(self, prefix: str) -> tuple[int, list[KeyValue]]:
        """Atomic (global_revision, range(prefix)) — a watch started at
        this revision misses nothing after the snapshot."""
        with self._lock:
            return self._rev, sorted(
                (kv for k, kv in self._data.items() if k.startswith(prefix)),
                key=lambda kv: kv.key,
            )

    @property
    def compact_rev(self) -> int:
        return self._compact_rev

    def compact(self, revision: int) -> None:
        """Drop replay history at or below ``revision`` (etcd Compact)."""
        with self._lock:
            revision = min(revision, self._rev)
            self._history = [
                ev for ev in self._history if ev.kv.mod_rev > revision
            ]
            self._compact_rev = max(self._compact_rev, revision)

    def range_interval_at(
        self, start: str, end: str, revision: int
    ) -> list[KeyValue]:
        """Range as of a historical ``revision`` (etcd MVCC read).

        No separate version store is needed: every retained WatchEvent
        carries ``prev``, so the state at R is the CURRENT state with each
        post-R-touched key rolled back to the ``prev`` of its FIRST event
        after R (prev=None there means the key did not exist at R). Keys
        untouched since R already carry their R-state in ``_data``. Valid
        exactly for R >= the compaction floor — the same floor watch
        resume uses (compact() and the history-cap trim both advance it).

        Raises CompactedRevision below the floor and FutureRevision above
        the current revision, mirroring etcd's ErrCompacted/ErrFutureRev.
        """
        with self._lock:
            if revision > self._rev:
                raise FutureRevision(revision, self._rev)
            if revision < self._compact_rev:
                raise CompactedRevision(revision, self._compact_rev)

            def in_range(k: str) -> bool:
                return k == start if not end else start <= k < end

            state = {
                kv.key: kv for kv in self.range_interval(start, end)
            }
            rolled: set[str] = set()
            for ev in self._history:  # ascending revision order
                key = ev.kv.key
                # Cheap key filter FIRST: for a point read most of the
                # (up to history_cap) events are other keys, and this scan
                # holds the store lock.
                if not in_range(key):
                    continue
                if ev.kv.mod_rev <= revision or key in rolled:
                    continue
                rolled.add(key)
                if ev.prev is not None:
                    state[key] = ev.prev
                else:
                    state.pop(key, None)
                if not end:
                    break  # point read: the single key is resolved
            return sorted(state.values(), key=lambda kv: kv.key)

    # -- writes -----------------------------------------------------------

    def put(self, key: str, value: bytes, lease: int = 0) -> KeyValue:
        with self._lock:
            return self._put_locked(key, value, lease)

    def _next_rev(self) -> int:
        """Allocate (or reuse, inside a batch) the next global revision."""
        if self._batch_depth and self._batch_rev_allocated:
            return self._rev
        self._rev += 1
        if self._batch_depth:
            self._batch_rev_allocated = True
        return self._rev

    @contextlib.contextmanager
    def batch(self):
        """Context manager: writes inside share ONE global revision (etcd
        txn/DeleteRange/lease-revoke semantics) and flush to watchers as
        ONE delivery at exit. Acquires the store lock; nests reentrantly
        (the outermost batch owns the revision and the flush)."""
        with self._lock:
            self._batch_depth += 1
            try:
                yield self
            finally:
                self._batch_depth -= 1
                if self._batch_depth == 0:
                    self._batch_rev_allocated = False
                    if self._batch_events:
                        events, self._batch_events = self._batch_events, []
                        self._deliver(events)

    def _put_locked(self, key: str, value: bytes, lease: int) -> KeyValue:
        if lease and lease not in self._leases:
            raise ValueError(f"lease {lease} does not exist")
        rev = self._next_rev()
        self._mutations += 1
        prev = self._data.get(key)
        kv = KeyValue(
            key=key,
            value=value,
            create_rev=prev.create_rev if prev else rev,
            mod_rev=rev,
            version=(prev.version + 1) if prev else 1,
            lease=lease,
        )
        self._data[key] = kv
        if prev and prev.lease and prev.lease != lease:
            attached = self._leases.get(prev.lease)
            if attached:
                attached[2].discard(key)
        if lease:
            self._leases[lease][2].add(key)
        self._emit(WatchEvent(EventType.PUT, kv, prev))
        return kv

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._delete_locked(key)

    def _delete_locked(self, key: str) -> bool:
        prev = self._data.pop(key, None)
        if prev is None:
            return False
        rev = self._next_rev()
        self._mutations += 1
        if prev.lease:
            attached = self._leases.get(prev.lease)
            if attached:
                attached[2].discard(key)
        tomb = KeyValue(
            key=key, value=b"", create_rev=prev.create_rev,
            mod_rev=rev, version=0, lease=0,
        )
        self._emit(WatchEvent(EventType.DELETE, tomb, prev))
        return True

    def txn(
        self,
        compares: Iterable[Compare],
        on_success: Iterable[Op],
        on_failure: Iterable[Op] = (),
    ) -> tuple[bool, list[KeyValue]]:
        with self.batch():  # one revision for the whole txn (etcd semantics)
            ok = all(
                (self._data.get(c.key).version if self._data.get(c.key) else 0)
                == c.version
                for c in compares
            )
            results: list[KeyValue] = []
            for op in on_success if ok else on_failure:
                if op.value is None:
                    self._delete_locked(op.key)
                else:
                    results.append(self._put_locked(op.key, op.value, op.lease))
            return ok, results

    # -- watch ------------------------------------------------------------

    def watch(
        self,
        prefix: str,
        callback: WatchCallback,
        start_rev: Optional[int] = None,
    ) -> WatchHandle:
        w = _Watcher(self, prefix, callback)
        with self._lock:
            replay = []
            if start_rev is not None:
                if start_rev < self._compact_rev:
                    # Requested history was compacted: full-state fallback —
                    # replay the current prefix contents as PUTs. Deletes in
                    # the compacted gap cannot be replayed; networked tiers
                    # detect the floor themselves (compact_rev) and run a
                    # resync that synthesizes them.
                    replay = [
                        WatchEvent(EventType.PUT, kv)
                        for kv in sorted(
                            (
                                kv for k, kv in self._data.items()
                                if k.startswith(prefix)
                            ),
                            key=lambda kv: kv.key,
                        )
                    ]
                else:
                    replay = [
                        ev
                        for ev in self._history
                        if ev.kv.mod_rev > start_rev
                        and ev.kv.key.startswith(prefix)
                    ]
            self._watchers.add(w)
        if replay:
            self._events.put((w, replay))
        return w

    def _emit(self, event: WatchEvent) -> None:
        # Caller holds the lock.
        self._history.append(event)
        if len(self._history) > self._history_cap:
            # Trim to half capacity; the floor advances to the newest
            # trimmed event's revision.
            drop = len(self._history) - self._history_cap // 2
            self._compact_rev = self._history[drop - 1].kv.mod_rev
            del self._history[:drop]
        if self._batch_depth:
            # Same-revision events deliver TOGETHER at batch exit.
            self._batch_events.append(event)
            return
        self._deliver([event])

    def _deliver(self, events: list[WatchEvent]) -> None:
        """Enqueue ``events`` as ONE delivery per matching watcher.
        Caller holds the lock."""
        for w in list(self._watchers):
            matched = [
                ev for ev in events if ev.kv.key.startswith(w.prefix)
            ]
            if matched:
                self._events.put((w, matched))

    def dispatch_barrier(self, fn) -> None:
        """Run ``fn(revision)`` on the dispatcher thread AFTER every event
        enqueued so far has been delivered to its watchers. ``revision`` is
        the store revision at enqueue time — by the time ``fn`` runs, all
        events up to it have reached their callbacks, so a progress-style
        notification built inside ``fn`` can never advertise a revision
        ahead of what a watcher has seen (etcd synced-watcher guarantee)."""
        with self._lock:
            self._events.put((None, (fn, self.revision)))

    def _dispatch_loop(self) -> None:
        while not self._closed.is_set():
            try:
                w, events = self._events.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                if w is None:  # dispatch_barrier entry
                    fn, rev = events
                    fn(rev)
                    continue
                if w.cancelled:
                    continue
                w.callback(events)
            except Exception:  # watcher bugs must not kill dispatch
                import traceback

                traceback.print_exc()

    # -- leases -----------------------------------------------------------

    def lease_grant(self, ttl_s: float) -> int:
        with self._lock:
            lease_id = next(self._lease_seq)
            self._leases[lease_id] = (
                self._clock.monotonic() + ttl_s, ttl_s, set()
            )
            return lease_id

    def lease_keepalive(self, lease_id: int) -> bool:
        with self._lock:
            entry = self._leases.get(lease_id)
            if entry is None:
                return False
            _, ttl_s, keys = entry
            self._leases[lease_id] = (
                self._clock.monotonic() + ttl_s, ttl_s, keys
            )
            return True

    def lease_revoke(self, lease_id: int) -> None:
        with self.batch():  # all attached keys drop at ONE revision  # analysis-ok: shared-state — batch() acquires and holds self._lock for the whole block (reentrant store batch)
            entry = self._leases.pop(lease_id, None)
            if entry is None:
                return
            for key in list(entry[2]):
                self._delete_locked(key)

    def _sweep_loop(self, interval: float) -> None:
        while not self._clock.wait_event(self._closed, interval):
            now = self._clock.monotonic()
            with self._lock:
                expired = [
                    lid for lid, (dl, _, _) in self._leases.items() if dl < now
                ]
                for lid in expired:
                    entry = self._leases.pop(lid)
                    with self.batch():  # one revision per expired lease
                        for key in list(entry[2]):
                            self._delete_locked(key)

    # -- engine surface (wire servers layering protocols over this store) --

    def locked(self):
        """Reentrant store lock as a context manager — for multi-op atomic
        sections (the etcd-lite Txn). Use with put_locked/delete_locked."""
        return self._lock

    def put_locked(self, key: str, value: bytes, lease: int = 0) -> KeyValue:
        """put() variant for callers already holding locked()."""
        return self._put_locked(key, value, lease)

    def delete_locked(self, key: str) -> bool:
        return self._delete_locked(key)

    def get_locked(self, key: str) -> Optional[KeyValue]:
        return self._data.get(key)

    def lease_exists(self, lease_id: int) -> bool:
        with self._lock:
            return lease_id in self._leases

    def lease_ttl(self, lease_id: int) -> Optional[float]:
        """Configured TTL of a live lease, None if it doesn't exist."""
        with self._lock:
            entry = self._leases.get(lease_id)
            return entry[1] if entry else None

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self._closed.set()

    # -- test helpers -------------------------------------------------------

    def wait_idle(self, timeout: float = 5.0) -> None:
        """Block until the watch event queue has drained (tests)."""
        deadline = time.monotonic() + timeout  #: wall-clock: test helper bounding REAL dispatcher-thread progress; a virtual deadline would never expire while the clock is parked
        while not self._events.empty():
            if time.monotonic() > deadline:  #: wall-clock: same wall bound as above
                raise TimeoutError("watch queue did not drain")
            time.sleep(0.005)  #: wall-clock: polls a real thread's queue drain
        time.sleep(0.02)  #: wall-clock: lets the in-flight callback finish on its real thread
