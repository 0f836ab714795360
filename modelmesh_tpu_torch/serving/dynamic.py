"""The port's own copy of the JAX package's ``serving/dynamic.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Live serving configuration: KV-watched knobs applied without restart.

Binds the DynamicConfig tier (kv/config.py, watched ``<prefix>/config``) to
running serving state — the reference applies these live from its watched
config map (ModelMesh.java:174-180, 1008-1061):

- ``scaleup_rpm_threshold`` — the rate task's per-copy scale-up threshold
  (and, symmetrically, the janitor's scale-down fraction base).
- ``log_each_invocation`` — per-request logging on the routing path.
- ``disable`` — admin drain. The value is a comma/space-separated list of
  instance ids (``*`` or ``all`` drains every instance): each listed
  instance advertises ``disabled`` so no new placements land on it (local
  loads refused, placement views exclude it) while already-loaded models
  keep serving.
"""

from __future__ import annotations

import logging

from modelmesh_tpu_torch.kv.config import DynamicConfig
from modelmesh_tpu_torch.kv.store import KVStore

log = logging.getLogger(__name__)

KEY_SCALEUP_RPM = "scaleup_rpm_threshold"
KEY_LOG_EACH_INVOCATION = "log_each_invocation"
KEY_DISABLE = "disable"


class ServingConfigBinder:
    """Applies watched config keys to an instance + its task config."""

    def __init__(self, store: KVStore, kv_prefix: str, instance, task_config):
        self.instance = instance
        self.task_config = task_config
        # Defaults to restore when a key is deleted.
        self._default_scale_up_rpm = task_config.scale_up_rpm
        self.config = DynamicConfig(store, f"{kv_prefix.rstrip('/')}/config")
        self.config.add_listener(self._on_change)
        for key in (KEY_SCALEUP_RPM, KEY_LOG_EACH_INVOCATION, KEY_DISABLE):
            self._apply(key)

    def _on_change(self, key: str, _value) -> None:
        self._apply(key)

    def _apply(self, key: str) -> None:
        if key == KEY_SCALEUP_RPM:
            new = self.config.get_int(KEY_SCALEUP_RPM, self._default_scale_up_rpm)
            if new < 1:
                log.warning(
                    "dynamic config: rejecting scaleup_rpm_threshold=%d "
                    "(must be >= 1); keeping %d",
                    new, self.task_config.scale_up_rpm,
                )
                return
            if new != self.task_config.scale_up_rpm:
                log.info("dynamic config: scale_up_rpm %d -> %d",
                         self.task_config.scale_up_rpm, new)
                self.task_config.scale_up_rpm = new
        elif key == KEY_LOG_EACH_INVOCATION:
            self.instance.log_each_invocation = self.config.get_bool(
                KEY_LOG_EACH_INVOCATION, False
            )
        elif key == KEY_DISABLE:
            raw = (self.config.get(KEY_DISABLE) or "").replace(",", " ")
            ids = {tok for tok in raw.split() if tok}
            disabled = (
                self.instance.instance_id in ids or bool(ids & {"*", "all"})
            )
            if disabled != self.instance.disabled:
                log.warning("dynamic config: instance %s disabled=%s",
                            self.instance.instance_id, disabled)
                self.instance.disabled = disabled
                # Re-advertise immediately so peers' placement views update
                # on the watch rather than the next publisher tick.
                try:
                    self.instance.publish_instance_record(force=True)
                except Exception:  # noqa: BLE001 — advisory re-publish
                    log.exception("republish after disable flip failed")

    def close(self) -> None:
        self.config.close()
