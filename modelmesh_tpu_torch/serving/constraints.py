"""The port's own copy of the JAX package's ``serving/constraints.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Type constraints + upgrade tracking: placement candidate filtering.

Two placement filters the reference applies before its LB walk:

- TypeConstraintManager (TypeConstraintManager.java, SURVEY.md section 2.1):
  heterogeneous clusters where model types may only load on instances with
  certain labels (``required``) and prefer others (``preferred``); config is
  JSON from an env var or a live-watched file (the ConfigMap pattern,
  ConfigMapKeyFileWatcher.java).
- UpgradeTracker (UpgradeTracker.java:17-32): during rolling updates, infer
  which replica sets are being replaced from instance-id structure
  (``<deployment>-<rs-hash>-<pod>``) and arrival order, and avoid placing
  new copies on pods of the outgoing set.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Optional, Sequence

from modelmesh_tpu_torch.cache.lru import now_ms
from modelmesh_tpu_torch.records import InstanceRecord

log = logging.getLogger(__name__)


class TypeConstraints:
    """model_type -> required/preferred instance labels.

    Config JSON:
    {"types": {
        "my-type": {"required": ["gpu"], "preferred": ["zone-a"]},
        "_default": {"required": []}
    }}
    """

    def __init__(self, config: Optional[dict] = None):
        self._lock = threading.Lock()
        self._types: dict[str, dict] = {}
        if config:
            self.update(config)

    @classmethod
    def from_json(cls, text: str) -> "TypeConstraints":
        return cls(json.loads(text) if text.strip() else None)

    def update(self, config: dict) -> None:
        types = config.get("types", config)
        with self._lock:
            self._types = {
                t: {
                    "required": set(spec.get("required", ())),
                    "preferred": set(spec.get("preferred", ())),
                }
                for t, spec in types.items()
            }

    def _spec(self, model_type: str) -> dict:
        with self._lock:
            return (
                self._types.get(model_type)
                or self._types.get("_default")
                or {"required": set(), "preferred": set()}
            )

    def is_candidate(self, model_type: str, labels: Sequence[str]) -> bool:
        spec = self._spec(model_type)
        return spec["required"] <= set(labels)

    def is_preferred(self, model_type: str, labels: Sequence[str]) -> bool:
        spec = self._spec(model_type)
        pref = spec["preferred"]
        return not pref or bool(pref & set(labels))

    def non_candidates(
        self, model_type: str,
        instances: Sequence[tuple[str, InstanceRecord]],
    ) -> set[str]:
        """Instance ids that must NOT host this model type."""
        return {
            iid for iid, rec in instances
            if not self.is_candidate(model_type, rec.labels)
        }


class ConstraintsFileWatcher:
    """Poll a JSON constraints file for live reload.

    The reference watches the ConfigMap ``..data`` symlink with inotify;
    mtime+content polling is the portable equivalent with the same observable
    behavior (sub-second pickup of atomic file replacement).
    """

    def __init__(
        self, path: str, constraints: TypeConstraints,
        poll_interval_s: float = 1.0,
    ):
        self.path = path
        self.constraints = constraints
        self._interval = poll_interval_s
        self._stop = threading.Event()
        self._last: Optional[bytes] = None
        self._load()
        self._thread = threading.Thread(
            target=self._loop, name="constraints-watch", daemon=True
        )
        self._thread.start()

    def _load(self) -> None:
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return
        if data == self._last:
            return
        self._last = data
        try:
            self.constraints.update(json.loads(data.decode() or "{}"))
            log.info("type constraints reloaded from %s", self.path)
        except Exception as e:  # noqa: BLE001 — a bad file must never kill
            # the watcher thread; keep serving the previous constraints.
            log.error("bad constraints file %s: %s", self.path, e)

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self._load()

    def close(self) -> None:
        self._stop.set()


def parse_instance_id(instance_id: str) -> tuple[str, str]:
    """``<deployment>-<rs-hash>-<pod-suffix>`` -> (deployment, replicaset).

    Ids that don't match the k8s naming shape map to themselves (no
    grouping, so the tracker never penalizes them).
    """
    parts = instance_id.rsplit("-", 2)
    if len(parts) == 3 and parts[1] and parts[2]:
        return parts[0], f"{parts[0]}-{parts[1]}"
    return instance_id, instance_id


class UpgradeTracker:
    """Infer replica sets being replaced during rolling updates.

    When instances from two replica sets of the same deployment coexist and
    the newer set's first arrival is recent, the older set is "likely being
    replaced": placement should avoid it (its pods will shut down soon).
    """

    def __init__(self, fresh_window_ms: int = 10 * 60_000):
        self.fresh_window_ms = fresh_window_ms
        # replicaset -> first time an instance of it was observed.
        self._first_seen: dict[str, int] = {}
        self._lock = threading.Lock()

    def observe(self, instances: Sequence[tuple[str, InstanceRecord]]) -> None:
        now = now_ms()
        with self._lock:
            live_rs = set()
            for iid, _rec in instances:
                _, rs = parse_instance_id(iid)
                live_rs.add(rs)
                self._first_seen.setdefault(rs, now)
            for rs in list(self._first_seen):
                if rs not in live_rs:
                    del self._first_seen[rs]

    def likely_replaced(
        self, instances: Sequence[tuple[str, InstanceRecord]]
    ) -> set[str]:
        """Instance ids in replica sets presumed outgoing."""
        self.observe(instances)
        now = now_ms()
        by_deploy: dict[str, list[str]] = {}
        for iid, _rec in instances:
            dep, rs = parse_instance_id(iid)
            by_deploy.setdefault(dep, [])
            if rs not in by_deploy[dep]:
                by_deploy[dep].append(rs)
        doomed_rs: set[str] = set()
        with self._lock:
            for dep, rss in by_deploy.items():
                if len(rss) < 2:
                    continue
                # Newest set = most recent first_seen; if it's fresh, all
                # older sets of this deployment are being replaced.
                rss.sort(key=lambda rs: self._first_seen.get(rs, 0))
                newest = rss[-1]
                if now - self._first_seen.get(newest, 0) <= self.fresh_window_ms:
                    doomed_rs.update(rss[:-1])
        return {
            iid for iid, _ in instances
            if parse_instance_id(iid)[1] in doomed_rs
        }
