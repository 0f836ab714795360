"""The port's own copy of the JAX package's ``autoscale/forecast.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Demand forecasting for predictive pre-warming.

The reactive half of the autoscale controller reads burn rates — it can
only react *after* latency starts degrading. This module is the
predictive half: a per-model demand estimate cheap enough to update on
every controller tick, whose only job is to answer "which models are
about to need more capacity than they have?" so the controller can
pre-warm the host tier (a 9 ms re-warm source) *before* the ramp
arrives instead of paying an 82 ms cold store load inside it.

Two estimators per model, both driven exclusively through the injectable
clock (``utils/clock``) so a sim scenario's forecasts are a pure
function of the virtual timeline:

- **EWMA pair** (fast/slow time constants): the fast average tracks the
  current rate, the slow one the baseline. ``fast >> slow`` is the
  trending signal, and the Holt-style projection
  ``fast + (fast - slow) * horizon/fast_tau`` extrapolates a ramp.
- **Diurnal phase**: a 24-bucket hour-of-day profile (cross-day EWMA of
  the observed rate in each bucket). A model that spikes every morning
  is forecast to spike *this* morning even while its EWMAs are still
  flat — the BLITZSCALE "warm before the wave" shape.

The forecaster is deliberately NOT thread-safe: it is owned by one
controller and mutated only from that controller's tick thread (the
same single-writer contract as the rate-task bookkeeping in
serving/tasks.py).
"""

from __future__ import annotations

import math

from modelmesh_tpu_torch.utils.clock import get_clock

HOUR_MS = 3_600_000
HOURS = 24
# Bounded model map: least-recently-observed entries are evicted on
# overflow so externally-driven id churn cannot grow the forecaster
# without bound (the kv-failfast sentinel rule, serving/instance.py).
MAX_MODELS = 4096


class _ModelStats:
    __slots__ = ("fast", "slow", "last_obs_ms", "hourly")

    def __init__(self, rate: float, now_ms: int):
        self.fast = rate
        self.slow = rate
        self.last_obs_ms = now_ms
        # hour-of-day -> EWMA rate; None = that phase never observed.
        self.hourly: list = [None] * HOURS


class DemandForecaster:
    """Per-model EWMA + diurnal-phase demand estimate.

    Rates are whatever unit the caller feeds (the controller feeds
    requests/min from ``ModelMeshInstance.model_rpm``); forecasts come
    back in the same unit.
    """

    def __init__(
        self,
        fast_tau_s: float = 120.0,
        slow_tau_s: float = 1800.0,
        diurnal_alpha: float = 0.3,
    ):
        self.fast_tau_s = max(float(fast_tau_s), 1e-3)
        self.slow_tau_s = max(float(slow_tau_s), self.fast_tau_s)
        self.diurnal_alpha = min(max(float(diurnal_alpha), 0.0), 1.0)
        self._models: dict[str, _ModelStats] = {}

    # -- feeding ------------------------------------------------------------

    def observe(self, model_id: str, rate: float, now_ms=None) -> None:
        """One rate sample for ``model_id`` (controller-tick cadence)."""
        now = int(now_ms if now_ms is not None else get_clock().now_ms())
        rate = max(float(rate), 0.0)
        st = self._models.get(model_id)
        if st is None:
            if len(self._models) >= MAX_MODELS:
                oldest = min(
                    self._models.items(), key=lambda kv: (kv[1].last_obs_ms, kv[0])
                )[0]
                del self._models[oldest]
            st = self._models[model_id] = _ModelStats(rate, now)
        else:
            dt_s = max(now - st.last_obs_ms, 0) / 1000.0
            # Time-decayed EWMA: irregular tick spacing (a paused sim,
            # a skipped KV-outage cycle) decays by elapsed time, not by
            # sample count.
            af = 1.0 - math.exp(-dt_s / self.fast_tau_s)
            as_ = 1.0 - math.exp(-dt_s / self.slow_tau_s)
            st.fast += af * (rate - st.fast)
            st.slow += as_ * (rate - st.slow)
            st.last_obs_ms = now
        hour = self._hour(now)
        prev = st.hourly[hour]
        if prev is None:
            st.hourly[hour] = rate
        else:
            st.hourly[hour] = prev + self.diurnal_alpha * (rate - prev)

    def drop(self, model_id: str) -> None:
        self._models.pop(model_id, None)

    def tracked(self) -> list[str]:
        return list(self._models)

    def __contains__(self, model_id: str) -> bool:
        return model_id in self._models

    # -- reading ------------------------------------------------------------

    @staticmethod
    def _hour(now_ms: int) -> int:
        return (now_ms // HOUR_MS) % HOURS

    def rate(self, model_id: str) -> float:
        st = self._models.get(model_id)
        return st.fast if st is not None else 0.0

    def forecast(self, model_id: str, horizon_s: float, now_ms=None) -> float:
        """Expected rate ``horizon_s`` from now: the Holt projection of
        the EWMA pair, floored by the diurnal estimate for the phase the
        horizon lands in (a flat present must not mask a known daily
        spike)."""
        st = self._models.get(model_id)
        if st is None:
            return 0.0
        projection = max(
            st.fast + (st.fast - st.slow) * (horizon_s / self.fast_tau_s),
            0.0,
        )
        now = int(now_ms if now_ms is not None else get_clock().now_ms())
        diurnal = st.hourly[self._hour(now + int(horizon_s * 1000))]
        if diurnal is not None:
            projection = max(projection, diurnal)
        return projection

    def trending(
        self,
        min_rate: float = 1.0,
        ratio: float = 1.5,
        horizon_s: float = 60.0,
        now_ms=None,
    ) -> list[str]:
        """Models whose demand is ramping: current fast EWMA at least
        ``min_rate`` and the ``horizon_s`` forecast at least ``ratio``
        times the slow baseline. Sorted hottest-forecast first with the
        id as tie-break so callers iterate deterministically."""
        now = int(now_ms if now_ms is not None else get_clock().now_ms())
        out = []
        for mid, st in self._models.items():
            if st.fast < min_rate:
                continue
            fc = self.forecast(mid, horizon_s, now_ms=now)
            if fc >= ratio * max(st.slow, 1e-9):
                out.append((-fc, mid))
        return [mid for _, mid in sorted(out)]

    def __len__(self) -> int:
        return len(self._models)
