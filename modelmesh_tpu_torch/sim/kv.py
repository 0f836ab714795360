"""The port's own copy of the JAX package's ``sim/kv.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Fault-injectable KV layer for the cluster simulator.

``SimKV`` wraps a (clock-threaded) ``InMemoryKV`` and hands each simulated
instance a per-instance facade (``for_instance``). Faults are injected at
the facade boundary — exactly where a real deployment's network sits:

- **partitions**: a blacked-out instance's ops raise ``ConnectionError``;
  its watch deliveries queue behind a paused per-facade worker and drain
  IN ORDER on heal (watch disconnect + catch-up semantics);
- **per-op latency**: virtual-time sleeps drawn from a seeded hash of
  (instance, op, key, per-key sequence);
- **CAS-conflict amplification**: guarded txns spuriously fail with
  probability ``cas_conflict_p`` (callers must re-read and retry — the
  contract every CAS loop in the codebase claims to honor);
- **watch delay / bounded reorder**: deliveries are held for a virtual
  delay; adjacent deliveries may swap ONLY when they share no key, so
  per-key order — the invariant real watch streams guarantee, and the
  one ``TableView``'s unconditional DELETE apply relies on — is never
  violated;
- **session expiry**: ``expire_instance_session`` revokes the lease under
  an instance's ephemeral advertisement out from under its SessionNode.

Determinism: the scenario TRACE (schedule + verdicts) is bit-for-bit
replayable from the seed. Fault draws are keyed on (seed, instance, op,
key, that key's op sequence) — independent of cross-key thread
interleavings, so a replay perturbs only draws whose own key saw a
genuinely racy op order; they are NOT hashed from a shared counter whose
value depends on unrelated threads' scheduling.
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Iterable, Optional, Sequence

from modelmesh_tpu_torch.kv.memory import InMemoryKV
from modelmesh_tpu_torch.kv.store import (
    Compare,
    KeyValue,
    KVStore,
    Op,
    WatchCallback,
    WatchHandle,
)
from modelmesh_tpu_torch.utils import clock as _clock


class SimKVConfig:
    def __init__(
        self,
        latency_ms: float = 0.0,
        latency_jitter_ms: float = 0.0,
        cas_conflict_p: float = 0.0,
        watch_delay_ms: float = 0.0,
        watch_reorder_p: float = 0.0,
    ):
        self.latency_ms = latency_ms
        self.latency_jitter_ms = latency_jitter_ms
        self.cas_conflict_p = cas_conflict_p
        self.watch_delay_ms = watch_delay_ms
        self.watch_reorder_p = watch_reorder_p


def _unit_hash(*parts) -> float:
    """Deterministic [0,1) draw from the identity of an operation."""
    h = hashlib.blake2b(
        "|".join(str(p) for p in parts).encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "big") / 2**64


class _SimWatchHandle(WatchHandle):
    def __init__(self, inner: WatchHandle):
        self._inner = inner

    def cancel(self) -> None:
        self._inner.cancel()


class _InstanceKV(KVStore):
    """Per-instance view of the shared SimKV: the injection boundary."""

    def __init__(self, sim: "SimKV", owner: str):
        self.sim = sim
        self.owner = owner
        # op-identity sequence numbers feeding the fault draws.
        self._op_counts: dict[tuple, int] = {}  #: guarded-by: _lock
        self._lock = threading.Lock()
        # Delayed/held watch deliveries: ONE FIFO per facade, drained by
        # one worker — global per-facade order is preserved (so per-key
        # order is too); the reorder fault swaps only key-disjoint
        # neighbors at enqueue time.
        #: guarded-by: _delivery_cv
        self._queue: collections.deque = collections.deque()
        self._worker: Optional[threading.Thread] = None  #: guarded-by: _delivery_cv
        self._dispatching = False  #: guarded-by: _delivery_cv
        self._closed = False  #: guarded-by: _delivery_cv
        self._delivery_cv = threading.Condition()

    # -- fault plumbing ----------------------------------------------------

    def _draw(self, op: str, key: str) -> float:
        with self._lock:
            n = self._op_counts.get((op, key), 0) + 1
            self._op_counts[(op, key)] = n
        return _unit_hash(self.sim.seed, self.owner, op, key, n)

    def _before_op(self, op: str, key: str = "") -> None:
        self.sim.check_partition(self.owner)
        self.sim.check_hold(self.owner, op, key)
        cfg = self.sim.config
        if cfg.latency_ms or cfg.latency_jitter_ms:
            extra = cfg.latency_jitter_ms * self._draw("lat:" + op, key)
            _clock.sleep((cfg.latency_ms + extra) / 1000.0)

    def _amplify_cas(self, compares: Sequence[Compare]) -> bool:
        cfg = self.sim.config
        if not compares or cfg.cas_conflict_p <= 0:
            return False
        return self._draw("cas", compares[0].key) < cfg.cas_conflict_p

    # -- reads -------------------------------------------------------------

    def get(self, key: str) -> Optional[KeyValue]:
        self._before_op("get", key)
        return self.sim.inner.get(key)

    def range(self, prefix: str) -> list[KeyValue]:
        self._before_op("range", prefix)
        return self.sim.inner.range(prefix)

    def range_from(self, prefix: str, start_key: str, limit: int):
        self._before_op("range_from", prefix)
        return self.sim.inner.range_from(prefix, start_key, limit)

    # -- writes ------------------------------------------------------------

    def put(self, key: str, value: bytes, lease: int = 0) -> KeyValue:
        self._before_op("put", key)
        return self.sim.inner.put(key, value, lease)

    def delete(self, key: str) -> bool:
        self._before_op("delete", key)
        return self.sim.inner.delete(key)

    def txn(
        self,
        compares: Iterable[Compare],
        on_success: Iterable[Op],
        on_failure: Iterable[Op] = (),
    ) -> tuple[bool, list[KeyValue]]:
        compares = list(compares)
        self._before_op("txn")
        # Hold gates match on the guarded key (the latency draw above
        # keeps its keyless identity so armed holds don't perturb the
        # seeded fault schedule of unrelated ops).
        if compares:
            self.sim.check_hold(self.owner, "txn", compares[0].key)
        if self._amplify_cas(compares):
            # Spurious conflict: by the CAS contract the caller re-reads
            # and retries; a correct caller converges, a broken one is
            # exactly what this fault exists to expose.
            return False, []
        return self.sim.inner.txn(compares, on_success, on_failure)

    # -- watch -------------------------------------------------------------

    def watch(
        self,
        prefix: str,
        callback: WatchCallback,
        start_rev: Optional[int] = None,
    ) -> WatchHandle:
        inner_handle = self.sim.inner.watch(
            prefix, lambda events: self._deliver(callback, events), start_rev
        )
        return _SimWatchHandle(inner_handle)

    def _deliver(self, callback: WatchCallback, events) -> None:
        """Runs on the inner store's (single) dispatch thread, so enqueue
        order is the store's event order. Fast path: nothing armed and no
        backlog — dispatch inline, exact real-store behavior. Otherwise
        queue behind the facade worker (partitioned deliveries just wait
        there until heal)."""
        cfg = self.sim.config
        partitioned = self.sim.is_partitioned(self.owner)
        delay = cfg.watch_delay_ms
        with self._delivery_cv:
            if (
                not partitioned
                and delay <= 0
                and not self._queue
                and not self._dispatching
            ):
                inline = True
            else:
                inline = False
                fire_at = _clock.get_clock().now_ms() + max(0.0, delay)
                entry = (fire_at, callback, list(events))
                if cfg.watch_reorder_p > 0 and self._queue:
                    keys_new = {ev.kv.key for ev in events}
                    tail = self._queue[-1]
                    keys_tail = {ev.kv.key for ev in tail[2]}
                    # Bounded reorder: swap with the neighbor ONLY when
                    # no key is shared — per-key order is sacrosanct.
                    if not (keys_new & keys_tail) and self._draw(
                        "reorder", min(keys_new, default="")
                    ) < cfg.watch_reorder_p:
                        self._queue.pop()
                        self._queue.append(entry)
                        entry = tail
                self._queue.append(entry)
                if self._worker is None:
                    self._worker = threading.Thread(
                        target=self._drain,
                        name=f"watch-queue-{self.owner}",
                        daemon=True,
                    )
                    self._worker.start()
                self._delivery_cv.notify_all()
        if inline:
            self._safe_dispatch(callback, events)

    def _drain(self) -> None:
        """Facade delivery worker: strictly FIFO, paused while the owner
        is partitioned, virtual-delay aware."""
        clock = _clock.get_clock()
        while True:
            with self._delivery_cv:
                entry = None
                while entry is None:
                    if self._closed:
                        return
                    if self._queue and not self.sim.is_partitioned(
                        self.owner
                    ):
                        fire_at, cb, evs = self._queue[0]
                        now = clock.now_ms()
                        if now >= fire_at:
                            self._queue.popleft()
                            self._dispatching = True
                            entry = (cb, evs)
                            continue
                        clock.cond_wait(
                            self._delivery_cv, (fire_at - now) / 1000.0
                        )
                    else:
                        # Empty, or partitioned: wait for an enqueue /
                        # heal kick / clock movement.
                        clock.cond_wait(self._delivery_cv, 60.0)
            try:
                self._safe_dispatch(*entry)
            finally:
                with self._delivery_cv:
                    self._dispatching = False
                    self._delivery_cv.notify_all()

    @staticmethod
    def _safe_dispatch(callback, events) -> None:
        try:
            callback(events)
        except Exception:  # noqa: BLE001 — watcher bugs must not kill sim
            import traceback

            traceback.print_exc()

    def kick(self) -> None:
        """Wake the delivery worker (heal, teardown)."""
        with self._delivery_cv:
            self._delivery_cv.notify_all()

    # -- leases ------------------------------------------------------------

    def lease_grant(self, ttl_s: float) -> int:
        self._before_op("lease_grant")
        return self.sim.inner.lease_grant(ttl_s)

    def lease_keepalive(self, lease_id: int) -> bool:
        self._before_op("lease_keepalive")
        return self.sim.inner.lease_keepalive(lease_id)

    def lease_revoke(self, lease_id: int) -> None:
        self._before_op("lease_revoke")
        self.sim.inner.lease_revoke(lease_id)

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        with self._delivery_cv:
            self._closed = True
            self._delivery_cv.notify_all()

    def wait_idle(self, timeout: float = 5.0) -> None:
        self.sim.inner.wait_idle(timeout)


class SimKV:
    """Shared fault-injection state over one InMemoryKV."""

    def __init__(
        self,
        seed: int = 0,
        config: Optional[SimKVConfig] = None,
        inner: Optional[InMemoryKV] = None,
    ):
        self.seed = seed
        self.config = config or SimKVConfig()
        self.inner = inner or InMemoryKV(sweep_interval_s=0.5)
        #: guarded-by: _lock
        self._partitioned: set[str] = set()
        #: guarded-by: _lock
        self._facades: dict[str, _InstanceKV] = {}
        # Write-hold gates: (owner, key-substring, release event). A
        # matching write BLOCKS (wall, not virtual) until released —
        # the deterministic way to model "this async mutation lands
        # arbitrarily late" (e.g. an eviction's deregister CAS racing
        # the quiesce). Released wholesale on close().
        #: guarded-by: _lock
        self._holds: list[tuple[str, str, threading.Event]] = []
        self._lock = threading.Lock()

    def for_instance(self, instance_id: str) -> KVStore:
        with self._lock:
            facade = self._facades.get(instance_id)
            if facade is None:
                facade = self._facades[instance_id] = _InstanceKV(
                    self, instance_id
                )
            return facade

    # -- partitions --------------------------------------------------------

    def partition(self, instance_id: str) -> None:
        with self._lock:
            self._partitioned.add(instance_id)

    def heal(self, instance_id: str) -> None:
        with self._lock:
            self._partitioned.discard(instance_id)
            facade = self._facades.get(instance_id)
        if facade is not None:
            facade.kick()  # the paused worker drains its backlog in order

    def is_partitioned(self, instance_id: str) -> bool:
        with self._lock:
            return instance_id in self._partitioned

    def check_partition(self, instance_id: str) -> None:
        if self.is_partitioned(instance_id):
            raise ConnectionError(
                f"simulated partition: {instance_id} cannot reach the KV"
            )

    # -- write-hold gates --------------------------------------------------

    def hold_writes(self, instance_id: str, key_substr: str) -> threading.Event:
        """Arm a gate: ``instance_id``'s writes touching a key containing
        ``key_substr`` block until the returned event is set."""
        ev = threading.Event()
        with self._lock:
            self._holds.append((instance_id, key_substr, ev))
        return ev

    def release_holds(self) -> None:
        with self._lock:
            holds, self._holds = self._holds, []
        for _, _, ev in holds:
            ev.set()

    def check_hold(self, instance_id: str, op: str, key: str) -> None:
        if not self._holds or not key:
            return
        if op not in ("put", "delete", "txn"):
            return
        with self._lock:
            holds = list(self._holds)
        for owner, sub, ev in holds:
            if owner == instance_id and sub in key:
                ev.wait()

    # -- session faults ----------------------------------------------------

    def expire_instance_session(self, session_key: str) -> bool:
        """Revoke the lease holding ``session_key`` (an instance's
        ephemeral advertisement) — simulated session expiry: the owner's
        next keepalive finds the lease gone and re-establishes."""
        kv = self.inner.get(session_key)
        if kv is None or not kv.lease:
            return False
        self.inner.lease_revoke(kv.lease)
        return True

    def close(self) -> None:
        self.release_holds()
        with self._lock:
            facades = list(self._facades.values())
        for facade in facades:
            facade.close()
        self.inner.close()
