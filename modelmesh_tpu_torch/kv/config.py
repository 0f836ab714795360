"""The port's own copy of the JAX package's ``kv/config.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Live dynamic configuration backed by a watched KV prefix.

Parity with the reference's DynamicConfig tier (SURVEY.md section 5.6):
string parameters under ``<prefix>/config`` with change listeners — e.g.
logger_level, log_each_invocation, scaleup_rpm_threshold, disable
(ModelMesh.java:174-180, 1008-1061). Values are UTF-8 strings with typed
getters; listeners fire with (key, new_value_or_None).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from modelmesh_tpu_torch.kv.store import EventType, KVStore

ConfigListener = Callable[[str, Optional[str]], None]


class DynamicConfig:
    def __init__(self, store: KVStore, prefix: str):
        if not prefix.endswith("/"):
            prefix += "/"
        self.store = store
        self.prefix = prefix
        self._values: dict[str, str] = {}
        self._lock = threading.RLock()
        self._listeners: list[ConfigListener] = []
        for kv in store.range(prefix):
            self._values[kv.key[len(prefix):]] = kv.value.decode()
        self._watch = store.watch(prefix, self._on_events)

    def add_listener(self, listener: ConfigListener) -> None:
        self._listeners.append(listener)

    def _on_events(self, events) -> None:
        for ev in events:
            key = ev.kv.key[len(self.prefix):]
            with self._lock:
                if ev.type is EventType.DELETE:
                    self._values.pop(key, None)
                    val: Optional[str] = None
                else:
                    val = ev.kv.value.decode()
                    self._values[key] = val
            for listener in self._listeners:
                try:
                    listener(key, val)
                except Exception:
                    import traceback

                    traceback.print_exc()

    # -- typed getters ------------------------------------------------------

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        with self._lock:
            return self._values.get(key, default)

    def get_int(self, key: str, default: int) -> int:
        v = self.get(key)
        try:
            return int(v) if v is not None else default
        except ValueError:
            return default

    def get_float(self, key: str, default: float) -> float:
        v = self.get(key)
        try:
            return float(v) if v is not None else default
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool) -> bool:
        v = self.get(key)
        if v is None:
            return default
        return v.strip().lower() in ("1", "true", "yes", "on")

    def set(self, key: str, value: str) -> None:
        """Write-through (admin/test convenience)."""
        self.store.put(self.prefix + key, value.encode())

    def close(self) -> None:
        self._watch.cancel()
