"""The port's own copy of the JAX package's ``kv/table.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Typed record tables over the KV store: KVTable + watch-fed TableView.

Capability parity with the kv-utils KVTable/TableView surface the reference
core consumes (registry/instances/vmodels tables built at
ModelMesh.java:582-628, 783-791): JSON-serialized records with versioned CAS
(conditionalSetAndGet idiom, e.g. ModelMesh.java:5200-5255), and a local
cache view maintained by a prefix watch with add/update/delete listeners.

The reference shards its registry over 128 fixed buckets
(ModelMesh.java:169) for watch-fanout and scan scalability.
BucketedKVTable mirrors that for the registry: keys live under
`<prefix>/<bucket-hex>/<id>` so scans proceed bucket-by-bucket in bounded
pages (a flat 100k-record range() response would blow the 16 MiB message
cap); the single prefix watch still covers every bucket, so TableView
needs no fan-in. Other tables (instances, vmodels) stay flat
`<prefix>/<id>` — their cardinality is bounded by fleet size.
"""

from __future__ import annotations

import enum
import json
import re
import threading
import time
from dataclasses import asdict
from typing import Callable, Generic, Iterator, Optional, Sequence, Type, TypeVar

from modelmesh_tpu_torch.kv.store import (
    CasFailed,
    Compare,
    EventType,
    KVStore,
    Op,
    WatchEvent,
)
from modelmesh_tpu_torch.utils.lockdebug import mm_rlock

R = TypeVar("R", bound="Record")


def _cas_backoff(attempt: int) -> None:
    """Bounded exponential backoff between CAS retry attempts.

    Contended retry loops over a shared wire connection can livelock in
    lockstep: every round trip re-enters the socket queue in the same
    order, so the same contender wins every round while the others burn
    their whole retry budget (observed against the ZooKeeper backend).
    A short, attempt-proportional pause desynchronizes the losers.

    Deliberately WALL time, not the injectable clock: this paces real
    wire I/O, and the retry loop can run on the simulation's advancing
    thread (the runner's inline janitor cycle) where a virtual sleep
    would wedge the clock beneath itself.
    """
    if attempt > 0:
        time.sleep(min(0.0005 * (1 << min(attempt - 1, 6)), 0.02))  #: wall-clock: CAS retry pacing; see _cas_backoff docstring


class Record:
    """Base for table records: JSON dataclass + KV version for CAS.

    Subclasses are dataclasses; ``version`` is infrastructure state (the
    KV per-key version used for conditional updates), not payload.
    """

    version: int = 0  # 0 = not persisted yet

    def to_bytes(self) -> bytes:
        d = asdict(self)  # type: ignore[arg-type]
        d.pop("version", None)
        return json.dumps(d, separators=(",", ":"), sort_keys=True).encode()

    @classmethod
    def from_bytes(cls: Type[R], data: bytes, version: int) -> R:
        d = json.loads(data.decode())
        # Forward compatibility across mixed-version rolling updates: a
        # newer peer may publish fields this version doesn't know; dropping
        # them beats a TypeError inside every watch callback.
        import dataclasses as _dc

        known = {f.name for f in _dc.fields(cls)}  # type: ignore[arg-type]
        obj = cls(**{k: v for k, v in d.items() if k in known})  # type: ignore[call-arg]
        obj.version = version
        return obj


# A bucket path segment ("<2-hex>/"), the test that tells a bucketed key
# from a legacy flat one. Model ids are arbitrary strings and MAY contain
# slashes, so "has a slash" is not the test — only a leading 2-hex-digit
# segment is a bucket. (An id that itself starts with "<2-hex>/" is
# genuinely ambiguous against this layout; don't name models that.)
BUCKET_SEG = re.compile(r"^[0-9a-f]{2}/")


def move_txn_parts(
    target_key: str, legacy_key: str, value: bytes,
    legacy_version: int, lease: int = 0,
) -> tuple[list[Compare], list[Op]]:
    """THE key-move transaction shape — single source of truth for the
    live layout migration (used by the migrator's sweep, move-on-write
    conditional_set, and batch_mutate). Two invariants live here and
    nowhere else: the create is absence-guarded and the legacy delete
    version-guarded (so exactly one move per key can ever commit), and
    the put PRECEDES the delete (so watch-fed views admit the canonical
    key before the legacy tombstone arrives)."""
    return (
        [Compare(target_key, 0), Compare(legacy_key, legacy_version)],
        [Op(target_key, value, lease), Op(legacy_key)],
    )


class TableEvent(enum.Enum):
    ADDED = "added"
    UPDATED = "updated"
    DELETED = "deleted"


# listener(event, key, record_or_None)
TableListener = Callable[[TableEvent, str, Optional[Record]], None]


class KVTable(Generic[R]):
    """Direct (uncached) typed access to records under a prefix."""

    def __init__(self, store: KVStore, prefix: str, record_cls: Type[R]):
        if not prefix.endswith("/"):
            prefix += "/"
        self.store = store
        self.prefix = prefix
        self.record_cls = record_cls

    def _key(self, id_: str) -> str:
        return self.prefix + id_

    def raw_key(self, id_: str) -> str:
        """Fully-qualified store key for ``id_`` — for callers composing
        multi-key store.txn()s across tables (e.g. vmodel promotion)."""
        return self._key(id_)

    def get(self, id_: str) -> Optional[R]:
        kv = self.store.get(self._key(id_))
        if kv is None:
            return None
        return self.record_cls.from_bytes(kv.value, kv.version)

    def put(self, id_: str, record: R, lease: int = 0) -> R:
        """Unconditional set; refreshes record.version."""
        kv = self.store.put(self._key(id_), record.to_bytes(), lease)
        record.version = kv.version
        return record

    def conditional_set(self, id_: str, record: R, lease: int = 0) -> R:
        """CAS on record.version (0 = create). Raises CasFailed on conflict.

        On success the record's version is refreshed in place — the
        conditionalSetAndGet idiom the reference uses for every registry
        update.
        """
        kv = self.store.put_if_version(
            self._key(id_), record.to_bytes(), record.version, lease
        )
        record.version = kv.version
        return record

    def conditional_delete(self, id_: str, expected_version: int) -> bool:
        return self.store.delete_if_version(self._key(id_), expected_version)

    def delete(self, id_: str) -> bool:
        return self.store.delete(self._key(id_))

    def key_to_id(self, key: str) -> str:
        """Store key -> record id (inverse of _key). Overridden by
        BucketedKVTable; TableView routes every watch event through it."""
        return key[len(self.prefix):]

    def scan(
        self, page_size: int = 1000
    ) -> Iterator[tuple[str, str, R]]:
        """Stream (id, store_key, record) in bounded pages. The key is
        what TableView's per-source-key event fencing needs during a
        live layout migration (two keys can transiently map to one id);
        plain callers use items()."""
        for kv in self.store.range_paged(self.prefix, page_size):
            yield self.key_to_id(kv.key), kv.key, self.record_cls.from_bytes(
                kv.value, kv.version
            )

    def items(self, page_size: int = 1000) -> Iterator[tuple[str, R]]:
        """Stream all records in bounded pages — safe at registry scale
        (one flat range() of 100k records would blow the message cap)."""
        for id_, _key, rec in self.scan(page_size):
            yield id_, rec

    def update_or_create(
        self, id_: str, mutate: Callable[[Optional[R]], Optional[R]],
        max_attempts: int = 20,
    ) -> Optional[R]:
        """Run a CAS retry loop: read, mutate, conditional-set.

        ``mutate`` gets the current record (None if absent) and returns the
        desired record (None = delete / no-op if also absent). Returns the
        final stored record (None if deleted/no-op).
        """
        for attempt in range(max_attempts):
            _cas_backoff(attempt)
            current = self.get(id_)
            desired = mutate(current)
            if desired is None:
                if current is None:
                    return None
                if self._conditional_delete_current(id_, current):
                    return None
                continue
            if current is not None and desired is not current:
                self._adopt_cas_meta(current, desired)
            desired.version = current.version if current is not None else 0
            try:
                return self.conditional_set(id_, desired)
            except CasFailed:
                continue
        raise CasFailed(f"update_or_create({id_}): too many CAS conflicts")

    # -- CAS plumbing hooks (overridden by BucketedKVTable's live
    # migration mode, where a record read from the legacy flat key must
    # CAS against THAT key and move on write) ---------------------------

    def _conditional_delete_current(self, id_: str, current: R) -> bool:
        """Delete guarded on the key/version ``current`` was read from."""
        return self.conditional_delete(id_, current.version)

    def _adopt_cas_meta(self, current: R, desired: R) -> None:
        """Propagate read-side CAS metadata when a mutate callback
        returns a NEW object instead of mutating in place."""

    def _record_key(self, id_: str, current: Optional[R]) -> str:
        """The store key ``current`` was read from (the CAS guard key)."""
        return self._key(id_)

    def batch_mutate(
        self,
        mutations: Sequence[tuple[str, Callable[[Optional[R]], Optional[R]]]],
        extra_ops: Sequence[Op] = (),
        max_attempts: int = 20,
    ) -> dict[str, Optional[R]]:
        """CAS-guarded multi-record mutation committed as ONE store txn.

        Each ``(id, mutate)`` follows update_or_create semantics (mutate
        gets current-or-None, returns desired-or-None meaning delete /
        no-op-if-absent), but every record write lands atomically in a
        single ``store.txn`` guarded on every record's version —
        collapsing N CAS round trips into one. ``extra_ops`` ride the same
        txn unconditionally (e.g. an instance-record publish piggybacked
        on a promote-loaded), so callers can merge table writes with
        adjacent-key updates without an extra RPC. Any version conflict
        retries the WHOLE batch from fresh reads.

        Returns id -> final record (None if deleted/absent no-op).
        """
        for attempt in range(max_attempts):
            _cas_backoff(attempt)
            compares: list[Compare] = []
            ops: list[Op] = []
            results: dict[str, Optional[R]] = {}
            writes: list[tuple[str, R, bool]] = []
            for id_, mutate in mutations:
                current = self.get(id_)
                desired = mutate(current)
                cur_version = current.version if current is not None else 0
                # The guard key is where the CURRENT record lives — during
                # a live layout migration that may be the legacy flat key.
                cur_key = self._record_key(id_, current)
                target = self._key(id_)
                compares.append(Compare(cur_key, cur_version))
                if desired is None:
                    results[id_] = None
                    if current is not None:
                        ops.append(Op(cur_key))  # delete
                else:
                    if current is not None and desired is not current:
                        self._adopt_cas_meta(current, desired)
                    desired.version = cur_version
                    moved = cur_key != target
                    if moved:
                        # Move-on-write (shape owned by move_txn_parts).
                        # The batch already carries Compare(cur_key,
                        # cur_version) from above; add the rest.
                        mc, mo = move_txn_parts(
                            target, cur_key, desired.to_bytes(), cur_version
                        )
                        compares.append(mc[0])
                        ops.extend(mo)
                    else:
                        ops.append(Op(target, desired.to_bytes()))
                    writes.append((id_, desired, moved))
                    results[id_] = desired
            ops.extend(extra_ops)
            if not ops:
                return results
            ok, _ = self.store.txn(compares, ops, [])
            if ok:
                # Refresh versions like conditional_set does (the
                # conditionalSetAndGet idiom): written keys bumped once;
                # a moved record is a fresh create at the canonical key.
                for id_, rec, moved in writes:
                    if moved:
                        rec.version = 1
                        rec._from_flat = False
                    else:
                        rec.version += 1
                return results
        raise CasFailed(
            f"batch_mutate({[i for i, _ in mutations]}): "
            "too many CAS conflicts"
        )


class BucketedKVTable(KVTable[R]):
    """KVTable sharded over fixed hash buckets (reference: 128 registry
    buckets, ModelMesh.java:169).

    Key layout: ``<prefix><bucket-hex>/<id>`` (prefix already ends in "/").
    Point ops stay O(1) — the bucket derives from the id hash (stable
    crc32, identical across processes/restarts; NEVER change n_buckets on
    a live table, existing keys would become unreachable). Scans iterate
    bucket-by-bucket so no single range RPC carries more than one bucket
    (~1/n_buckets of the table) per page. The whole table still nests
    under one prefix, so a TableView's single prefix watch covers every
    bucket without fan-in.

    Legacy FLAT keys (``<prefix><id>`` from pre-bucketing versions) are
    normally NOT read by this table: migrate them with
    ``kv/migrate.py`` (``migrate_flat_registry`` and its live twin; the
    command line comes with the launcher). During a FENCED LIVE
    migration (kv/migrate.py: the operator advertises a migration epoch
    every instance's ``migration_fence`` watches) the table switches to
    dual-read + move-on-write semantics:

    - reads fall back to the flat key when the bucketed one is absent
      (bucketed preferred — exactly one value per id), marking the
      record ``_from_flat`` so its CAS guards the key it came from;
    - any CAS against a flat-read record commits as one txn that
      creates the bucketed key (absence-guarded) and deletes the flat
      one (version-guarded): the first writer to touch a record migrates
      it, and the migrator's own move txn uses the same guards, so
      exactly one move per key can ever commit (no split brain);
    - scans dedupe with bucketed preferred.

    An earlier UNFENCED lazy migrate-on-read was removed deliberately —
    without the epoch fence, two keys mapping to one id broke TableView
    (spurious DELETED events) and split CAS writers across a
    mixed-version fleet. The fence plus TableView's per-source-key event
    fencing are what make the live mode sound.
    """

    def __init__(
        self, store: KVStore, prefix: str, record_cls: Type[R],
        n_buckets: int = 128, migration_fence=None,
    ):
        super().__init__(store, prefix, record_cls)
        self.n_buckets = n_buckets
        # kv.migrate.MigrationFence (or None): live-migration epoch.
        self.migration_fence = migration_fence

    def _fence_active(self) -> bool:
        fence = self.migration_fence
        return fence is not None and fence.active

    def flat_key(self, id_: str) -> str:
        """The pre-bucketing legacy key for ``id_``."""
        return self.prefix + id_

    def _bucket(self, id_: str) -> int:
        import zlib

        return zlib.crc32(id_.encode()) % self.n_buckets

    def _key(self, id_: str) -> str:
        return f"{self.prefix}{self._bucket(id_):02x}/{id_}"

    def key_to_id(self, key: str) -> str:
        rest = key[len(self.prefix):]
        if BUCKET_SEG.match(rest):
            return rest[3:]
        # Legacy flat key (pre-bucketing layout / mid-live-migration):
        # the whole rest IS the id — which may itself contain slashes,
        # so never split on the first one.
        return rest

    # Scans inherit range_paged over the whole prefix (every RPC bounded
    # by page_size — iterating 128 bucket prefixes separately would
    # impose a >=128-RPC floor per scan for nothing); the live-migration
    # override below only adds the flat/bucketed dedupe.

    def get(self, id_: str) -> Optional[R]:
        rec = super().get(id_)
        if rec is None and self._fence_active():
            kv = self.store.get(self.flat_key(id_))
            if kv is not None:
                rec = self.record_cls.from_bytes(kv.value, kv.version)
                rec._from_flat = True
            else:
                # TOCTOU: a move txn can commit between the bucketed
                # miss and the flat read, making a record that exists
                # throughout look absent (and absent = "unregistered" to
                # callers like the janitor, which would drop the serving
                # copy). The move is atomic, so one more bucketed read
                # closes the window.
                rec = super().get(id_)
        return rec

    def scan(
        self, page_size: int = 1000
    ) -> Iterator[tuple[str, str, R]]:
        if not self._fence_active():
            yield from super().scan(page_size)
            return
        # Dual-scan dedupe, bucketed preferred. Flat entries are buffered
        # to the end (flat/bucketed keys interleave in sort order, so a
        # flat record can precede its bucketed twin in the stream); the
        # buffer is bounded by the unmigrated remainder, which only
        # shrinks as the migration proceeds. Deliberate trade-off: at
        # migration START the remainder is the whole registry, so a scan
        # (TableView seed, janitor pass) holds every flat record and the
        # flush below pays one canonical-key re-read per still-flat id —
        # O(remaining) extra gets, correctness-first for the short
        # operator-run window between advertise(LIVE) and DONE. (The
        # seed already materializes the full table regardless.)
        flat: dict[str, tuple[str, R]] = {}
        bucketed: set[str] = set()
        for kv in self.store.range_paged(self.prefix, page_size):
            id_ = self.key_to_id(kv.key)
            rec = self.record_cls.from_bytes(kv.value, kv.version)
            if BUCKET_SEG.match(kv.key[len(self.prefix):]):
                bucketed.add(id_)
                yield id_, kv.key, rec
            else:
                rec._from_flat = True
                flat[id_] = (kv.key, rec)
        for id_, (key, rec) in flat.items():
            if id_ in bucketed:
                continue
            # Same TOCTOU as get(): a move landing after this flat entry
            # was buffered (into a page position already consumed) would
            # make the buffered copy stale and the bucketed form silently
            # missing from the stream — re-read the canonical key and
            # yield whichever form now exists.
            kv = self.store.get(self._key(id_))
            if kv is not None:
                yield id_, kv.key, self.record_cls.from_bytes(
                    kv.value, kv.version
                )
            else:
                yield id_, key, rec

    def conditional_set(self, id_: str, record: R, lease: int = 0) -> R:
        if not getattr(record, "_from_flat", False):
            return super().conditional_set(id_, record, lease)
        # Move-on-write: the record was read from the legacy flat key —
        # commit the mutation at the canonical bucketed key and retire
        # the flat one in ONE txn (shape owned by move_txn_parts; the
        # migrator's sweep uses the same helper, so this and it are the
        # mutually-exclusive CAS writers for the move).
        target = self._key(id_)
        flat = self.flat_key(id_)
        ok, _ = self.store.txn(
            *move_txn_parts(target, flat, record.to_bytes(),
                            record.version, lease)
        )
        if not ok:
            raise CasFailed(id_)
        record.version = 1  # fresh create at the canonical key
        record._from_flat = False
        return record

    def _conditional_delete_current(self, id_: str, current: R) -> bool:
        if not getattr(current, "_from_flat", False):
            return super()._conditional_delete_current(id_, current)
        flat = self.flat_key(id_)
        ok, _ = self.store.txn(
            [Compare(flat, current.version)], [Op(flat)], []
        )
        return ok

    def _adopt_cas_meta(self, current: R, desired: R) -> None:
        if getattr(current, "_from_flat", False):
            desired._from_flat = True

    def _record_key(self, id_: str, current: Optional[R]) -> str:
        if current is not None and getattr(current, "_from_flat", False):
            return self.flat_key(id_)
        return self._key(id_)

    def delete(self, id_: str) -> bool:
        # An unregistration mid-migration must retire BOTH forms — and
        # FLAT FIRST: every move txn guards on the flat key's version,
        # so once the flat form is gone no mover can re-create the
        # bucketed one; deleting bucketed first would let a move commit
        # between the two deletes and resurrect the record.
        deleted = False
        if self._fence_active():
            deleted = self.store.delete(self.flat_key(id_))
        return super().delete(id_) or deleted


class TableView(Generic[R]):
    """Local watch-maintained cache of a KVTable with change listeners.

    Every placement decision in the reference reads these local views, not
    the KV store directly (registry.getView(), instance table listener at
    ModelMesh.java:1455-1568).
    """

    def __init__(self, table: KVTable[R]):
        self.table = table
        self._cache: dict[str, R] = {}  #: guarded-by: _lock
        # id -> the store key the cached record came from. Normally the
        # canonical key; during a live layout migration (BucketedKVTable
        # dual mode) two keys transiently map to one id, and events are
        # fenced per SOURCE key: a move txn's DELETE of the legacy key
        # must never evict the just-applied canonical record, and a
        # legacy-key PUT must never clobber a canonical one — so a
        # mixed-epoch view holds exactly one record per id throughout.
        self._src: dict[str, str] = {}  #: guarded-by: _lock
        self._lock = mm_rlock("TableView._lock")
        self._listeners: list[TableListener] = []
        self._ready = threading.Event()
        # Notified after every applied change; wait_for blocks on this
        # instead of sleep-polling (wakeup latency = notification latency).
        # Own lock, not _lock: waiters must never hold the view lock.
        self._change_cv = threading.Condition()
        # Monotone view version: bumped on every APPLIED change (stale
        # watch replays don't count). Readers key derived snapshots on it
        # (ModelMeshInstance caches its ClusterView per epoch) so the
        # request hot path copies the table only when it actually moved.
        self._epoch = 0  #: guarded-by: _lock
        # Store KEYS deleted by the watch before the initial seed lands;
        # the seed must not resurrect them from its older listing. None
        # once seeding completed (the common steady state).
        #: guarded-by: _lock
        self._seed_tombstones: Optional[set[str]] = set()
        # Subscribe from revision 0 so pre-existing records replay as events.
        self._watch = table.store.watch(
            table.prefix, self._on_events, start_rev=0
        )
        # Seed synchronously for immediate availability; watch replay will
        # redeliver, which the admit rules treat idempotently by version.
        # The paged table scan runs OUTSIDE _lock (blocking-under-lock:
        # the watch dispatcher must never convoy behind an O(table) KV
        # scan), so a watch event may be APPLIED before the seed lands —
        # the seed installs through the same admit rules (never clobbering
        # a newer watch-applied record with the stale listing) and skips
        # keys the watch already deleted (_seed_tombstones).
        seed = list(table.scan())
        with self._lock:
            tombstones = self._seed_tombstones or ()
            for id_, key, rec in seed:
                if key in tombstones:
                    continue
                self._admit_locked(id_, key, rec)
            self._seed_tombstones = None
            self._epoch += 1
        self._ready.set()

    def add_listener(self, listener: TableListener) -> None:
        self._listeners.append(listener)

    def _admit_locked(
        self, id_: str, key: str, rec: R
    ) -> Optional[TableEvent]:
        """Install ``rec`` (from store key ``key``) unless fenced off;
        returns the event to fire, or None. Callers hold _lock.

        Versions compare only WITHIN one source key (per-key counters are
        unrelated across keys); across keys the canonical key wins —
        that is the bucketed-preferred rule that keeps a migrating view
        at one record per id."""
        prev = self._cache.get(id_)
        if prev is not None:
            prev_key = self._src.get(id_, key)
            if prev_key == key:
                if prev.version >= rec.version:
                    return None  # stale/duplicate replay
            elif key != self.table.raw_key(id_):
                # A non-canonical (legacy) put while the canonical record
                # is cached: fenced off, the canonical one is newer by
                # construction (the move created it from the legacy value).
                return None
        self._cache[id_] = rec
        self._src[id_] = key
        return TableEvent.ADDED if prev is None else TableEvent.UPDATED

    def _on_events(self, events: list[WatchEvent]) -> None:
        for ev in events:
            id_ = self.table.key_to_id(ev.kv.key)
            with self._lock:
                if ev.type is EventType.DELETE:
                    if self._seed_tombstones is not None:
                        self._seed_tombstones.add(ev.kv.key)
                    rec = None
                    # Per-source-key fencing: the delete only applies when
                    # the cached record came from THIS key (a move txn's
                    # legacy-key tombstone arrives after the canonical
                    # put and must not evict it).
                    if (
                        id_ in self._cache
                        and self._src.get(id_, ev.kv.key) == ev.kv.key
                    ):
                        self._cache.pop(id_, None)
                        self._src.pop(id_, None)
                        event = TableEvent.DELETED
                    else:
                        event = None
                else:
                    rec = self.table.record_cls.from_bytes(
                        ev.kv.value, ev.kv.version
                    )
                    event = self._admit_locked(id_, ev.kv.key, rec)
                if event is not None:
                    self._epoch += 1
            if event is not None:
                for listener in self._listeners:
                    listener(event, id_, rec)
                with self._change_cv:
                    self._change_cv.notify_all()

    # -- read API ----------------------------------------------------------

    def get(self, id_: str) -> Optional[R]:
        with self._lock:
            return self._cache.get(id_)

    def items(self) -> list[tuple[str, R]]:
        with self._lock:
            return list(self._cache.items())

    @property
    def epoch(self) -> int:
        """Current view version (see __init__). Lock-free read: a torn
        read is impossible for a GIL-atomic int, and callers only compare
        for equality against a snapshot's recorded epoch."""
        return self._epoch

    def snapshot(self) -> tuple[int, list[tuple[str, R]]]:
        """(epoch, items) captured atomically — the pair a caller needs to
        build an epoch-keyed derived view without a lost-update window
        between reading the version and copying the table."""
        with self._lock:
            return self._epoch, list(self._cache.items())

    def __len__(self) -> int:
        return len(self._cache)

    def __contains__(self, id_: str) -> bool:
        return id_ in self._cache

    def wait_ready(self, timeout: float = 10.0) -> None:
        if not self._ready.wait(timeout):
            raise TimeoutError("table view initialization timed out")

    def wait_for(
        self,
        predicate: Callable[["TableView[R]"], bool],
        timeout: float = 10.0,
        poll_s: float = 0.25,
    ) -> None:
        """Test helper: block until predicate(self) is true.

        Event-driven: woken by the change condition on every applied
        watch event, so the wait adds notification latency, not poll
        slack; ``poll_s`` only bounds the re-check cadence for
        predicates that depend on state outside this view. Deliberately
        real-time (it bounds real thread progress, like wait_idle)."""
        deadline = time.monotonic() + timeout  #: wall-clock: test helper bounding REAL watch-thread progress (docstring above)
        while not predicate(self):
            remaining = deadline - time.monotonic()  #: wall-clock: same wall bound as above
            if remaining <= 0:
                raise TimeoutError("condition not reached")
            with self._change_cv:
                # Benign race (predicate checked outside the cv): an event
                # applied between the check and this wait just costs one
                # poll_s slice, never a missed wakeup past the deadline.
                self._change_cv.wait(min(remaining, poll_s))

    def close(self) -> None:
        self._watch.cancel()
