"""The port's own copy of the JAX package's ``kv/migrate.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Registry key-layout migration: flat keys -> bucketed layout.

The registry moved from flat ``<prefix>/registry/<id>`` keys to the
bucketed ``<prefix>/registry/<bb>/<id>`` layout (BucketedKVTable,
kv/table.py). Two migration modes:

**Offline** (``migrate_flat_registry``): fleet stopped (or before the
first bucketed-version pod starts). Each move is one atomic txn
(create-bucketed guarded on absence + delete-flat guarded on version),
so re-running after an interruption is safe and concurrent writers lose
cleanly (the key is re-scanned).

**Live** (``migrate_flat_registry_live``): the fleet keeps serving. The
migrator first advertises a migration *epoch* under
``<prefix>/migration/registry`` — a fence every instance watches
(``MigrationFence``). While the fence is LIVE:

- readers dual-read: ``BucketedKVTable.get``/``items`` fall back to the
  flat key when the bucketed one is absent, preferring bucketed — a
  mixed-epoch reader sees exactly ONE value per id;
- writers move-on-write: a CAS against a record read from the flat key
  commits as ``[create bucketed (absent-guarded) + delete flat
  (version-guarded)]`` in one txn — the first writer to touch a record
  migrates it, and the single-CAS-writer-per-key guarantee means the
  migrator and a concurrent writer can never both commit (the loser
  re-reads and finds the moved key);
- ``TableView`` fences watch events per source key (kv/table.py): the
  move's ``DELETE flat`` never evicts the just-applied bucketed record,
  so watch-fed views keep exactly one record per id throughout.

When a scan pass finds zero flat keys the migrator advertises DONE and
readers drop the dual-read fallback. The flat->bucketed direction is
what exists today; the mechanism is layout-agnostic.

    python -m modelmesh_tpu_torch.kv.migrate --kv etcd://host:2379 --prefix mm [--live]
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Optional

from modelmesh_tpu_torch.kv.store import KVStore
from modelmesh_tpu_torch.kv.table import BUCKET_SEG, move_txn_parts
from modelmesh_tpu_torch.utils.clock import now_ms

log = logging.getLogger(__name__)

# Fence phases advertised under <prefix>/migration/registry.
PHASE_LIVE = "live"     # dual-read + move-on-write in force
PHASE_DONE = "done"     # bucketed-only; fallback reads off


def migration_fence_key(prefix: str) -> str:
    return f"{prefix.rstrip('/')}/migration/registry"


def advertise_phase(store: KVStore, prefix: str, phase: str) -> None:
    """Publish the migration epoch. Unconditional put: the migrator is a
    single operator-run tool; phase changes are monotone (live -> done)."""
    store.put(
        migration_fence_key(prefix),
        json.dumps({"phase": phase, "ts_ms": now_ms()}).encode(),
    )


class MigrationFence:
    """Watch-fed view of the registry-migration epoch.

    One tiny key, one watch: every instance's ``BucketedKVTable`` holds a
    fence and checks ``active`` per read-miss — the property that keeps
    mixed-epoch readers consistent is that the fence is advertised
    BEFORE the first key moves and stays up until after the last one,
    so any reader that could observe a half-moved registry is already
    dual-reading.
    """

    def __init__(self, store: KVStore, prefix: str):
        self.key = migration_fence_key(prefix)
        # None = no migration recorded.
        self._phase: Optional[str] = None  #: guarded-by: _lock
        self._lock = threading.Lock()
        # Seed BEFORE registering the watch: the rev-0 replay redelivers
        # every phase change in order, so the watch can only move the
        # state forward — seeding after registration could overwrite a
        # newer watch-applied phase with the stale read (a fence pinned
        # LIVE forever on an instance that boots mid-flip).
        kv = store.get(self.key)
        if kv is not None:
            self._apply(kv.value)
        self._watch = store.watch(self.key, self._on_events, start_rev=0)

    def _on_events(self, events) -> None:
        for ev in events:
            if ev.kv.key != self.key:
                continue
            self._apply(ev.kv.value if ev.kv.value else None)

    def _apply(self, raw: Optional[bytes]) -> None:
        phase = None
        if raw:
            try:
                phase = json.loads(raw.decode()).get("phase")
            except Exception:  # noqa: BLE001 — junk fence = no fence
                log.warning("unparseable migration fence value %r", raw)
        with self._lock:
            self._phase = phase

    @property
    def phase(self) -> Optional[str]:
        with self._lock:
            return self._phase

    @property
    def active(self) -> bool:
        """True while dual-read/move-on-write semantics are required."""
        return self.phase == PHASE_LIVE

    def close(self) -> None:
        self._watch.cancel()


def _registry_table(store: KVStore, prefix: str, n_buckets: int,
                    fence: Optional[MigrationFence] = None):
    from modelmesh_tpu_torch.kv.table import BucketedKVTable
    from modelmesh_tpu_torch.records import ModelRecord

    return BucketedKVTable(
        store, f"{prefix.rstrip('/')}/registry", ModelRecord,
        n_buckets=n_buckets, migration_fence=fence,
    )


def _move_pass(store: KVStore, table, page_size: int) -> tuple[int, int]:
    """One scan over the registry prefix: move every flat key into its
    bucket. Returns (moved, remaining_flat) — remaining counts keys that
    lost their CAS this pass (a concurrent writer moved or changed them;
    the next pass re-examines)."""
    moved = 0
    remaining = 0
    for kv in list(store.range_paged(table.prefix, page_size)):
        rest = kv.key[len(table.prefix):]
        if BUCKET_SEG.match(rest):
            # Already bucketed. (A plain slash test would be wrong:
            # model ids may contain slashes, and a flat key for such an
            # id must still migrate.)
            continue
        target = table.raw_key(rest)
        # Single CAS writer per key: the txn shape (absence-guarded
        # create + version-guarded delete, put before delete) is owned
        # by kv.table.move_txn_parts — the same shape move-on-write
        # writers use, so the migrator and a concurrent writer commit at
        # most one move between them.
        ok, _ = store.txn(
            *move_txn_parts(target, kv.key, kv.value, kv.version)
        )
        if ok:
            moved += 1
        else:
            remaining += 1
            log.info("move of %s lost its CAS (concurrent writer); "
                     "will re-scan", rest)
    return moved, remaining


def migrate_flat_registry(
    store: KVStore, prefix: str = "mm", n_buckets: int = 128,
    page_size: int = 500,
) -> int:
    """Offline move of every flat registry key; returns moves made."""
    table = _registry_table(store, prefix, n_buckets)
    moved, remaining = _move_pass(store, table, page_size)
    if remaining:
        log.warning("%d keys skipped (concurrent change; re-run)", remaining)
    return moved


def migrate_flat_registry_live(
    store: KVStore, prefix: str = "mm", n_buckets: int = 128,
    page_size: int = 500, settle_s: float = 0.5, max_passes: int = 64,
) -> int:
    """Fenced live migration against a serving fleet; returns moves made.

    Advertises PHASE_LIVE, waits ``settle_s`` for every instance's fence
    watch to catch up (so no reader is still bucketed-only when the
    first key moves), then runs move passes until one finds nothing flat
    — concurrent writers shrink the work by moving records themselves —
    and advertises PHASE_DONE.
    """
    from modelmesh_tpu_torch.utils.clock import sleep as clock_sleep

    advertise_phase(store, prefix, PHASE_LIVE)
    if settle_s > 0:
        clock_sleep(settle_s)
    table = _registry_table(store, prefix, n_buckets)
    total = 0
    for _ in range(max_passes):
        moved, remaining = _move_pass(store, table, page_size)
        total += moved
        if moved == 0 and remaining == 0:
            break
    else:
        raise RuntimeError(
            f"live migration did not converge in {max_passes} passes "
            "(flat keys keep appearing — is an old-version writer still "
            "running?)"
        )
    advertise_phase(store, prefix, PHASE_DONE)
    return total


def main() -> None:
    import argparse

    from modelmesh_tpu_torch.serving.main import build_store

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--kv", required=True,
                        help="mesh://host:port, etcd://host:port, or "
                             "zookeeper://host:port")
    parser.add_argument("--prefix", default="mm")
    parser.add_argument("--buckets", type=int, default=128)
    parser.add_argument("--live", action="store_true",
                        help="fenced live migration against a serving "
                             "fleet (dual-read + move-on-write epoch)")
    args = parser.parse_args()
    logging.basicConfig(level="INFO")
    store = build_store(args.kv)
    try:
        if args.live:
            moved = migrate_flat_registry_live(
                store, args.prefix, args.buckets
            )
        else:
            moved = migrate_flat_registry(store, args.prefix, args.buckets)
        print(f"migrated {moved} flat registry keys")
    finally:
        close = getattr(store, "close", None)
        if close:
            close()


if __name__ == "__main__":
    main()
