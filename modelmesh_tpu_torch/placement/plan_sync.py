"""The port's own copy of the JAX package's ``placement/plan_sync.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Fleet-wide plan distribution over the KV store.

The leader's reaper solves one global assignment (torch_engine.solve_plan) and
publishes the serialized GlobalPlan under ``<prefix>/plan``; every instance —
leader included — runs a PlanFollower that watches that key and installs each
published plan into its TorchPlacementStrategy. This closes the loop the
reference closes through the shared registry (leader placement decisions at
ModelMesh.java:6616-6747 become visible to all instances via registry
watches): placement decisions taken at ANY instance follow the central solve,
while per-instance local guards (capacity, churn age, exclusions) remain
authoritative and greedy remains the fallback for plan misses.

Size discipline: the KV data plane caps values at the gRPC message limit
(16 MiB default, serving config). A 100k-model plan compresses well under
that, but the publisher still enforces a byte budget by truncating the
placement map (models beyond the budget simply fall back to greedy at the
followers) rather than failing the publish or splitting into
non-atomically-visible chunks.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from modelmesh_tpu_torch.kv.store import EventType, KVStore, WatchHandle
from modelmesh_tpu_torch.placement.torch_engine import GlobalPlan

log = logging.getLogger(__name__)

PLAN_KEY = "plan"
# The plan byte budget lives in the MM_MAX_PLAN_BYTES env registration
# (utils/envs.py, default 12 MiB — headroom under the 16 MiB data plane).
# Absolute staleness bound on ADOPTION, judged by the publisher's solve
# timestamp (generous to tolerate clock skew — plans are advisory). Without
# it, an instance starting hours after the leader died would resurrect the
# orphaned plan with a fresh TTL from its initial read.
MAX_PLAN_WALL_AGE_MS = 60 * 60_000


def plan_key(prefix: str) -> str:
    return f"{prefix.rstrip('/')}/{PLAN_KEY}"


def publish_plan(
    store: KVStore,
    prefix: str,
    plan: GlobalPlan,
    max_bytes: Optional[int] = None,
) -> int:
    """Serialize + put the plan; returns the published byte size.

    ``max_bytes`` defaults from the MM_MAX_PLAN_BYTES env knob
    (utils/envs.py) so operators can tune the plan byte budget without a
    code change. If the serialized plan exceeds it, the placement map is
    truncated from the TAIL. This relies on solve_plan emitting placements
    hottest-first (torch_engine.py sorts by problem rates precisely so this
    truncation sheds the coldest models); reordering the placement dict
    breaks that invariant. Dropped models serve greedy at followers.
    """
    if max_bytes is None:
        from modelmesh_tpu_torch.utils import envs

        max_bytes = envs.get_int("MM_MAX_PLAN_BYTES")
    store_cap = store.max_value_bytes()
    if store_cap is not None:
        max_bytes = min(max_bytes, store_cap)
    data = plan.to_bytes()
    if len(data) > max_bytes:
        # Binary-search-free trim: drop proportionally and re-check once,
        # then hard-drop in halves until under budget.
        n_keep = plan.num_models()
        while n_keep and len(data) > max_bytes:
            keep = max(1, int(n_keep * max_bytes / len(data) * 0.9))
            if keep >= n_keep:
                keep = n_keep // 2
            n_keep = keep
            data = plan.truncate(n_keep).to_bytes()
        log.warning(
            "plan publish truncated to %d models (%d bytes, budget %d)",
            n_keep, len(data), max_bytes,
        )
    store.put(plan_key(prefix), data)
    return len(data)


class PlanFollower:
    """Watch-fed plan subscription: installs published plans into a strategy.

    Attach to any strategy exposing ``adopt(plan|None)`` (TorchPlacementStrategy).
    The initial state is read synchronously so an instance that starts after
    the leader's last solve still serves the current plan immediately.
    """

    def __init__(self, store: KVStore, prefix: str, strategy) -> None:
        self._key = plan_key(prefix)
        self._strategy = strategy
        self._handle: Optional[WatchHandle] = None
        # Revision fencing: the constructor's synchronous reads and the
        # watch callbacks are two unordered delivery paths; installing only
        # monotonically newer mod_revs keeps a descheduled initial read from
        # clobbering a fresher watch-delivered plan.
        self._lock = threading.Lock()
        self._last_rev = 0
        start_rev = None
        try:
            kv = store.get(self._key)
            if kv is not None:
                self._decode_and_adopt(kv.value, kv.mod_rev)
                start_rev = kv.mod_rev
        except Exception:  # noqa: BLE001 — plan is advisory; greedy covers
            log.exception("initial plan read failed; starting from watch")
        self._handle = store.watch(self._key, self._on_events, start_rev=start_rev)
        if start_rev is None:
            # Close the get->watch gap: a plan published in between would be
            # invisible to a None-start watch (no replay) until the next
            # solve. One post-subscription read covers it; the watch handles
            # everything after.
            try:
                kv = store.get(self._key)
                if kv is not None:
                    self._decode_and_adopt(kv.value, kv.mod_rev)
            except Exception:  # noqa: BLE001
                pass

    def _decode_and_adopt(self, value: bytes, mod_rev: int) -> None:
        try:
            plan = GlobalPlan.from_bytes(value)
        except Exception:  # noqa: BLE001 — a bad plan must not kill the watch
            log.exception("discarding undecodable published plan")
            return
        wall_age = plan.adopted_at_ms - plan.solved_at_ms
        if wall_age > MAX_PLAN_WALL_AGE_MS:
            log.warning(
                "ignoring orphaned plan (solved %.0f min ago — leader gone?)",
                wall_age / 60_000,
            )
            return
        # Build the model->row index here, in the watch thread, so the first
        # routed request after adoption doesn't pay for it.
        plan.ensure_index()
        with self._lock:
            if mod_rev <= self._last_rev:
                return
            self._last_rev = mod_rev
            self._strategy.adopt(plan)

    def _on_events(self, events) -> None:
        for ev in events:
            if ev.kv.key != self._key:
                continue  # prefix watch may over-match sibling keys
            if ev.type is EventType.PUT:
                self._decode_and_adopt(ev.kv.value, ev.kv.mod_rev)
            else:
                with self._lock:
                    if ev.kv.mod_rev > self._last_rev:
                        self._last_rev = ev.kv.mod_rev
                        self._strategy.adopt(None)

    def close(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
