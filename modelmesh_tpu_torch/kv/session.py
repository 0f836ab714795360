"""The port's own copy of the JAX package's ``kv/session.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Ephemeral session nodes and leader election on top of KV leases.

Parity targets from the reference's kv-utils usage:
- SessionNode: an instance's liveness advertisement — an ephemeral key bound
  to a TTL lease, auto-refreshed, republished if the lease is lost
  (ModelMesh.java:788 `myNode.start()`; liveness semantics in SURVEY.md
  section 5.3).
- LeaderElection: lowest-create-revision candidate wins (etcd election
  recipe); used for the reaper/janitorial leader role
  (ModelMesh.java:819-825 leaderLatch).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from modelmesh_tpu_torch.kv.store import EventType, KVStore
from modelmesh_tpu_torch.utils import clock as _clock
from modelmesh_tpu_torch.utils.lockdebug import mm_lock

log = logging.getLogger(__name__)


class SessionNode:
    """Ephemeral key kept alive by a background keepalive thread.

    ``_lock`` guards only the ``(_lease, _value)`` bookkeeping — every KV
    round trip (lease grant, put, revoke) runs OUTSIDE it, so a slow or
    wedged store can never convoy callers that only need the bookkeeping
    (``publish_op`` riding someone else's txn, the keepalive probe).
    Concurrent publishes converge through ``_establish``'s re-check loop:
    whichever put lands last, the final republished value is the newest
    ``_value``.
    """

    def __init__(
        self,
        store: KVStore,
        key: str,
        value: bytes,
        ttl_s: float = 5.0,
        keepalive_interval_s: Optional[float] = None,
    ):
        self.store = store
        self.key = key
        self._value = value  #: guarded-by: _lock
        self.ttl_s = ttl_s
        self._interval = keepalive_interval_s or ttl_s / 3.0
        self._lease: Optional[int] = None  #: guarded-by: _lock
        # keepalive-thread-private failure-streak flag (log throttling).
        self._keepalive_failing = False
        # Keepalive cadence follows the injectable clock (virtual under
        # the sim harness); the stop event is clock-aware so close() wakes
        # a virtual-time wait immediately.
        self._clock = _clock.get_clock()
        self._stop = self._clock.new_event()
        self._thread: Optional[threading.Thread] = None
        self._lock = mm_lock("SessionNode._lock")

    def start(self) -> None:
        self._establish()
        self._thread = threading.Thread(
            target=self._keepalive_loop, name=f"session-{self.key}", daemon=True
        )
        self._thread.start()

    def _establish(self) -> None:
        """Grant a fresh lease and publish the latest value (RPCs outside
        ``_lock``). An ``update`` racing the republish is converged by the
        re-check loop; a newer concurrent ``_establish`` supersedes us.
        A ``close()`` racing the grant is caught by the ``_stop`` check
        under ``_lock``: either close pops-and-revokes the installed
        lease, or we see the stop flag and revoke the fresh grant
        ourselves — the ephemeral can never outlive close until TTL."""
        lease = self.store.lease_grant(self.ttl_s)
        with self._lock:
            if self._stop.is_set():
                orphan = lease  # closed while the grant was in flight
            else:
                orphan = None
                self._lease = lease
                value = self._value
        if orphan is not None:
            try:
                self.store.lease_revoke(orphan)
            except Exception:  # noqa: BLE001 — TTL expiry backstops
                pass
            return
        self._publish_latest(value, lease)

    def _publish_latest(self, value: bytes, lease: int) -> None:
        """Put + converge: if another publisher advanced ``_value`` (or a
        re-establish swapped the lease) while our put was in flight,
        republish until the final KV state carries the newest value under
        the CURRENT lease. The lease re-check cannot simply return on
        supersession: the new lease's republish may have already landed
        BEFORE our stale put, which then rebound the ephemeral to the
        dying old lease — the repair must re-put under the live one.
        After ``close()`` (lease None) the loop stops: close revokes the
        lease it popped, and any ephemeral a stale put rebound to an
        older lease dies with that lease's TTL."""
        while True:
            self.store.put(self.key, value, lease=lease)
            with self._lock:
                if self._lease is None:
                    return  # closed
                if self._lease != lease:
                    # Superseded mid-put: repair under the current lease.
                    lease = self._lease
                    value = self._value
                    continue
                if self._value is value:
                    return
                value = self._value  # a publisher raced the put: redo

    def update(self, value: bytes) -> None:
        """Republish the node's value (instance record refresh). The put
        runs outside ``_lock`` so a slow KV round trip cannot block
        ``publish_op``/keepalive bookkeeping on the same node. A put that
        fails because the lease was revoked/replaced mid-flight (close()
        or a keepalive re-establish won the race) is swallowed — the new
        lease's establish republishes the latest ``_value``, and after
        close there is deliberately nothing to publish."""
        with self._lock:
            self._value = value
            lease = self._lease
        if lease is None:
            return
        try:
            self._publish_latest(value, lease)
        except Exception:
            with self._lock:
                still_ours = self._lease == lease
            if still_ours:
                raise

    def publish_op(self, value: bytes):
        """An ``Op`` updating this node, for riding someone else's txn
        (the batched promote-loaded + instance-record publish). Records
        the value as the node's latest so a later lease re-establish
        republishes it; returns None when no lease is live yet (caller
        falls back to a standalone ``update``-style publish)."""
        from modelmesh_tpu_torch.kv.store import Op

        with self._lock:
            self._value = value
            if self._lease is None:
                return None
            return Op(self.key, value, lease=self._lease)

    def _keepalive_loop(self) -> None:
        while not self._clock.wait_event(self._stop, self._interval):
            with self._lock:
                lease = self._lease
            if lease is not None:
                try:
                    alive = self.store.lease_keepalive(lease)
                except Exception as e:  # noqa: BLE001 — transient store error
                    # Partition/outage: the lease may still be live server-
                    # side, so don't churn it — retry next tick; if it DID
                    # expire meanwhile, the False branch below re-grants.
                    # First failure of a streak at WARNING so a real
                    # outage is visible without per-tick spam.
                    if not self._keepalive_failing:
                        self._keepalive_failing = True
                        log.warning(
                            "session %s keepalive failed (will retry "
                            "each tick): %s", self.key, e,
                        )
                    continue
                if self._keepalive_failing:
                    self._keepalive_failing = False
                    log.info("session %s keepalive recovered", self.key)
                if alive:
                    continue
            # Lease lost (KV hiccup / expiry): re-grant and republish.
            try:
                self._establish()
            except Exception:
                pass  # retry next tick

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)  #: wall-clock: bounds a REAL keepalive-thread teardown at close
        with self._lock:
            lease, self._lease = self._lease, None
        if lease is not None:
            try:
                self.store.lease_revoke(lease)
            except Exception:
                pass


class LeaderElection:
    """Lowest-create-revision election under a prefix.

    Each candidate writes an ephemeral key; the candidate whose key has the
    lowest create revision is leader. A prefix watch re-evaluates on any
    membership change and invokes ``on_change(is_leader)`` on transitions.
    """

    def __init__(
        self,
        store: KVStore,
        prefix: str,
        candidate_id: str,
        on_change: Callable[[bool], None],
        ttl_s: float = 5.0,
    ):
        if not prefix.endswith("/"):
            prefix += "/"
        self.store = store
        self.prefix = prefix
        self.candidate_id = candidate_id
        self.on_change = on_change
        self._node = SessionNode(
            store, prefix + candidate_id, candidate_id.encode(), ttl_s=ttl_s
        )
        self._is_leader = False  #: guarded-by: _lock
        self._lock = mm_lock("LeaderElection._lock")
        self._watch = None

    @property
    def is_leader(self) -> bool:
        return self._is_leader

    def start(self) -> None:
        self._node.start()
        self._watch = self.store.watch(self.prefix, self._on_events)
        self._evaluate()

    def _on_events(self, events) -> None:
        if any(
            ev.type in (EventType.PUT, EventType.DELETE) for ev in events
        ):
            self._evaluate()

    def _evaluate(self) -> None:
        kvs = self.store.range(self.prefix)
        leader = min(kvs, key=lambda kv: kv.create_rev).key if kvs else None
        me = leader == self.prefix + self.candidate_id
        fire = False
        with self._lock:
            if me != self._is_leader:
                self._is_leader = me
                fire = True
        if fire:
            try:
                self.on_change(me)
            except Exception:
                import traceback

                traceback.print_exc()

    def close(self) -> None:
        if self._watch is not None:
            self._watch.cancel()
        self._node.close()
        with self._lock:
            was = self._is_leader
            self._is_leader = False
        if was:
            try:
                self.on_change(False)
            except Exception:
                pass
