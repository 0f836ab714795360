"""The port's own copy of the JAX package's ``placement/shadow.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Shadow-mode strategy evaluation: serve greedy, measure the solver.

SURVEY.md section 7 build plan step 9 prescribes running the JAX global
strategy "in shadow-mode vs greedy before promoting": every LOAD-placement
decision is taken by the ``primary`` (production) strategy, while the
``shadow`` strategy answers the same question on the side (serve-target
balancing is not scored — the solver strategy serves via its greedy fallback
by design, so that comparison would be tautological). Agreement is
counted, recent divergences are kept for the ***STATE*** dump, and shadow
failures can never affect serving — operators read the agreement rate,
then promote the solver strategy with evidence instead of faith.

The reference has no analog (its heuristics are hardcoded inline); this is
the promotion-safety half of the PlacementStrategy SPI departure.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Optional

from modelmesh_tpu_torch.placement.strategy import (
    ClusterView,
    PlacementRequest,
    PlacementStrategy,
)
from modelmesh_tpu_torch.records import ModelRecord

log = logging.getLogger(__name__)


class ShadowStrategy(PlacementStrategy):
    """Route decisions through ``primary``; score ``shadow`` on the side.

    Divergence is not error: the solver legitimately disagrees with greedy
    (that's why it exists) — the operator question is whether its answers
    are *plausible* (valid instances, stable rate). ``stats()`` gives the
    rates; ``recent_divergences`` the concrete cases to eyeball.
    """

    def __init__(
        self,
        primary: PlacementStrategy,
        shadow: PlacementStrategy,
        keep_recent: int = 64,
    ):
        self.primary = primary
        self.shadow = shadow
        self._lock = threading.Lock()
        self._counts = collections.Counter()
        self._recent = collections.deque(maxlen=keep_recent)

    # -- attach points (instance wiring fans state into both sides) --------

    @property
    def time_stats(self):
        return getattr(self.primary, "time_stats", None)

    @time_stats.setter
    def time_stats(self, ts) -> None:
        for s in (self.primary, self.shadow):
            if hasattr(s, "time_stats"):
                s.time_stats = ts
            fb = getattr(s, "fallback", None)
            if fb is not None and hasattr(fb, "time_stats"):
                fb.time_stats = ts

    @property
    def constraints(self):
        return getattr(self.primary, "constraints", None)

    @constraints.setter
    def constraints(self, c) -> None:
        for s in (self.primary, self.shadow):
            if hasattr(s, "constraints") and getattr(s, "constraints") is None:
                s.constraints = c
            fb = getattr(s, "fallback", None)
            if fb is not None and hasattr(fb, "constraints") and (
                getattr(fb, "constraints", None) is None
            ):
                fb.constraints = c

    def adopt(self, plan) -> None:
        """PlanFollower feed: published plans flow to the shadow solver."""
        if hasattr(self.shadow, "adopt"):
            self.shadow.adopt(plan)

    def refresh(self, models, instances, rpm_fn=None):
        """Leader reaper cadence (serving/tasks.py): a shadow fleet must
        still SOLVE and publish plans — without this, no plan ever exists,
        the shadow permanently answers from its greedy fallback, and the
        agreement metric reads ~1.0: false evidence, the exact failure
        shadow mode exists to prevent."""
        return self.shadow.refresh(models, instances, rpm_fn)

    # -- decision SPI -------------------------------------------------------

    def _observe(self, kind: str, model_id: str, primary_out, shadow_fn):
        try:
            shadow_out = shadow_fn()
        except Exception as e:  # noqa: BLE001 — shadow must never hurt
            with self._lock:
                self._counts[f"{kind}_shadow_error"] += 1
            log.debug("shadow %s failed for %s: %s", kind, model_id, e)
            return
        with self._lock:
            if shadow_out == primary_out:
                self._counts[f"{kind}_agree"] += 1
            else:
                self._counts[f"{kind}_diverge"] += 1
                self._recent.append(
                    {"kind": kind, "model": model_id,
                     "primary": primary_out, "shadow": shadow_out}
                )

    def choose_load_target(
        self, req: PlacementRequest, view: ClusterView
    ) -> Optional[str]:
        out = self.primary.choose_load_target(req, view)
        self._observe(
            "load", req.model_id, out,
            lambda: self.shadow.choose_load_target(req, view),
        )
        return out

    def choose_serve_target(
        self, model: ModelRecord, view: ClusterView, exclude: frozenset[str]
    ) -> Optional[str]:
        # NOT scored: the solver strategy serves via its greedy fallback by
        # design (balancing needs fresh busyness, not a global solve —
        # torch_engine.choose_serve_target), so shadow-vs-primary here would
        # compare greedy to greedy and report a tautological 1.0 agreement
        # — false promotion evidence. Only load placement carries solver
        # signal.
        return self.primary.choose_serve_target(model, view, exclude)

    def rank_serve_candidates(
        self, model: ModelRecord, view: ClusterView, exclude: frozenset[str]
    ):
        # Unscored pass-through, same rationale as choose_serve_target.
        return self.primary.rank_serve_candidates(model, view, exclude)

    # -- reporting ----------------------------------------------------------

    def shadow_stats(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
            recent = list(self._recent)
        out: dict = {"counts": counts, "recent_divergences": recent}
        # Only load placement is scored (serve decisions pass through
        # unscored — see choose_serve_target).
        agree = counts.get("load_agree", 0)
        total = agree + counts.get("load_diverge", 0)
        if total:
            out["load_agreement"] = round(agree / total, 4)
        return out
