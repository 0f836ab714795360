"""The port's own copy of the JAX package's ``utils/clock.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Process-wide injectable clock: the time seam for deterministic simulation.

Every module that used to call ``time.time`` / ``time.monotonic`` /
``time.sleep`` (or the derived ``now_ms``) for *logical* time — cadences,
leases, timeouts, timestamps in records — reads through this module
instead. Production installs nothing and pays one extra attribute lookup
(``SystemClock`` delegates straight to ``time``); the simulation harness
(``modelmesh_tpu_torch/sim/``) installs a ``VirtualClock`` so hours of
janitor/reaper/lease cadence advance in milliseconds of wall time.

Clock-injection rules for new code (see docs/testing.md):

- logical waits (task cadences, lease TTLs, load timeouts, coalesce
  windows) go through ``get_clock()`` — ``now_ms``/``monotonic``/``sleep``,
  ``wait_event`` for interruptible sleeps, ``cond_wait`` for timed
  condition waits, ``call_later`` for one-shot timers;
- events a clock wait sleeps on must come from ``Clock.new_event()`` so
  ``set()`` wakes virtual-time waiters immediately;
- *physical* time stays on ``time``: wire I/O pacing, gRPC deadlines,
  perf_counter metrics, and test helpers that bound real thread progress
  (``wait_idle`` / ``wait_for``) — virtualizing those would deadlock the
  sim against real threads.
"""

from __future__ import annotations

import contextlib
import heapq
import threading
import time as _time
from typing import Callable, Optional

# Fixed virtual epoch: simulations start at a deterministic wall time so
# record timestamps are bit-for-bit reproducible across runs.
VIRTUAL_EPOCH_MS = 1_700_000_000_000


class Clock:
    """Interface; ``SystemClock`` is the zero-overhead default."""

    def now_ms(self) -> int:
        raise NotImplementedError

    def monotonic(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def new_event(self) -> threading.Event:
        """An Event whose ``set()`` also wakes this clock's waiters."""
        return threading.Event()

    def wait_event(self, event: threading.Event, timeout_s: float) -> bool:
        """``event.wait(timeout)`` through the clock; returns is_set."""
        raise NotImplementedError

    def cond_wait(self, cv, timeout_s: Optional[float]) -> None:
        """One timed wait slice on an ALREADY-ACQUIRED condition. May
        return spuriously early — callers re-check their predicate and
        remaining budget, exactly as with ``Condition.wait``."""
        raise NotImplementedError

    def call_later(self, delay_s: float, fn: Callable[[], None],
                   name: str = "clock-timer"):
        """One-shot timer; returns a handle with ``cancel()``."""
        raise NotImplementedError


class SystemClock(Clock):
    def now_ms(self) -> int:
        return int(_time.time() * 1000)

    def monotonic(self) -> float:
        return _time.monotonic()

    def sleep(self, seconds: float) -> None:
        _time.sleep(seconds)

    def wait_event(self, event: threading.Event, timeout_s: float) -> bool:
        return event.wait(timeout_s)

    def cond_wait(self, cv, timeout_s: Optional[float]) -> None:
        cv.wait(timeout_s)

    def call_later(self, delay_s: float, fn: Callable[[], None],
                   name: str = "clock-timer"):
        t = threading.Timer(delay_s, fn)
        t.daemon = True
        t.name = name
        t.start()
        return t


class _KickingEvent(threading.Event):
    """Event that wakes the owning VirtualClock's waiters on ``set()`` —
    without the kick, a waiter blocked under virtual time would only
    notice the flag at the next clock advance."""

    def __init__(self, clock: "VirtualClock"):
        super().__init__()
        self._clock = clock

    def set(self) -> None:  # noqa: A003 — threading.Event API
        super().set()
        self._clock.kick()


class _VirtualTimer:
    __slots__ = ("deadline_ms", "fn", "name", "cancelled", "race_token")

    def __init__(self, deadline_ms: int, fn, name: str):
        self.deadline_ms = deadline_ms
        self.fn = fn
        self.name = name
        self.cancelled = False
        # MM_RACE_DEBUG schedule->fire happens-before edge: the
        # scheduler's clock, adopted by the timer body in _run_timer.
        from modelmesh_tpu_torch.utils import racedebug

        self.race_token = racedebug.task_created()

    def cancel(self) -> None:
        self.cancelled = True


class VirtualClock(Clock):
    """Discrete virtual time driven by ``advance``.

    Waiters (``sleep`` / ``wait_event`` / ``cond_wait``) block on real
    condition variables and are woken by ``advance`` (or ``kick``), then
    re-check virtual deadlines — no wall time passes while waiting.
    ``advance`` fires due ``call_later`` timers on the advancing thread,
    outside the clock lock (timer bodies may do KV I/O and take locks).

    The caller decides cadence: the scenario runner advances in bounded
    steps (so lease keepalives run between TTL checks, like real time),
    and injects large single jumps only as an explicit clock-skew fault
    (a jump IS a freeze — leases expiring across it is the semantics).
    """

    # Real-time guard slice while blocked: waiters re-check closed/state
    # at this cadence even if no advance wakes them, so an abandoned
    # clock can never wedge interpreter exit.
    _GUARD_WAIT_S = 30.0

    def __init__(self, start_ms: int = VIRTUAL_EPOCH_MS):
        self._start_ms = start_ms
        self._cv = threading.Condition()
        self._now = start_ms  #: guarded-by: _cv
        self._closed = False  #: guarded-by: _cv
        #: guarded-by: _cv
        self._cond_waiters: dict[int, object] = {}  # waiter id -> cv
        self._waiter_seq = 0  #: guarded-by: _cv
        #: guarded-by: _cv
        self._timers: list[tuple[int, int, _VirtualTimer]] = []
        self._timer_seq = 0  #: guarded-by: _cv
        self._sleepers = 0  #: guarded-by: _cv

    # -- reads -------------------------------------------------------------

    def now_ms(self) -> int:
        return self._now

    def monotonic(self) -> float:
        return (self._now - self._start_ms) / 1000.0

    @property
    def waiters(self) -> int:
        """Threads currently blocked in clock waits (diagnostics)."""
        with self._cv:
            return self._sleepers + len(self._cond_waiters)

    # -- waiting -----------------------------------------------------------

    def sleep(self, seconds: float) -> None:
        with self._cv:
            deadline = self._now + max(0.0, seconds) * 1000.0
            self._sleepers += 1
            try:
                while self._now < deadline and not self._closed:
                    self._cv.wait(self._GUARD_WAIT_S)
            finally:
                self._sleepers -= 1

    def new_event(self) -> threading.Event:
        return _KickingEvent(self)

    def wait_event(self, event: threading.Event, timeout_s: float) -> bool:
        closed = False
        with self._cv:
            deadline = self._now + max(0.0, timeout_s) * 1000.0
            self._sleepers += 1
            try:
                while not event.is_set():
                    if self._closed:
                        closed = True
                        break
                    if self._now >= deadline:
                        break
                    self._cv.wait(self._GUARD_WAIT_S)
            finally:
                self._sleepers -= 1
        if closed:
            # Clock torn down under a still-running loop: park briefly on
            # real time so a straggler thread can't hot-spin its cadence.
            event.wait(min(max(timeout_s, 0.0), 0.5))
        return event.is_set()

    def cond_wait(self, cv, timeout_s: Optional[float]) -> None:
        # Caller holds cv's lock. Registration takes the clock lock while
        # holding cv's — safe because advance/kick NEVER notify a foreign
        # cv while holding the clock lock (they collect under it, notify
        # outside), so the cv -> clock._cv order has no reverse edge.
        if timeout_s is not None and timeout_s <= 0:
            return
        with self._cv:
            if self._closed:
                closed = True
            else:
                closed = False
        if closed:
            # Torn-down clock: behave like real time (bounded) so waiter
            # loops park instead of spinning on a frozen virtual deadline.
            cv.wait(min(timeout_s, 0.5) if timeout_s is not None else 0.5)
            return
        with self._cv:
            if self._closed:
                return
            self._waiter_seq += 1
            key = self._waiter_seq
            self._cond_waiters[key] = cv
        try:
            # Woken by a product notify on cv OR by advance/kick/close
            # broadcasting to registered cvs; spurious wakes are fine —
            # every caller loops on predicate + remaining budget.
            cv.wait(self._GUARD_WAIT_S)
        finally:
            with self._cv:
                self._cond_waiters.pop(key, None)

    # -- timers ------------------------------------------------------------

    def call_later(self, delay_s: float, fn: Callable[[], None],
                   name: str = "clock-timer") -> _VirtualTimer:
        with self._cv:
            deadline = int(self._now + max(0.0, delay_s) * 1000.0)
            t = _VirtualTimer(deadline, fn, name)
            self._timer_seq += 1
            heapq.heappush(self._timers, (deadline, self._timer_seq, t))
            return t

    # -- driving -----------------------------------------------------------

    def advance(self, ms: float) -> None:
        """Move virtual time forward and wake everything due."""
        due: list[_VirtualTimer] = []
        cvs: list[object]
        with self._cv:
            self._now += max(0, ms)
            while self._timers and self._timers[0][0] <= self._now:
                _, _, t = heapq.heappop(self._timers)
                if not t.cancelled:
                    due.append(t)
            cvs = list(self._cond_waiters.values())
            self._cv.notify_all()
        self._notify_foreign(cvs)
        for t in due:
            # Fire OFF the advancing thread: timer bodies are foreign code
            # (publish flushes, delayed watch deliveries) that may itself
            # block on virtual time — running it here would stop the clock
            # underneath it.
            threading.Thread(
                target=self._run_timer, args=(t,), name=t.name, daemon=True
            ).start()

    @staticmethod
    def _run_timer(t: _VirtualTimer) -> None:
        from modelmesh_tpu_torch.utils import racedebug

        try:
            racedebug.task_begin(t.race_token)
            t.fn()
        except Exception:  # noqa: BLE001 — timer bodies are foreign code
            import traceback

            traceback.print_exc()

    def kick(self) -> None:
        """Wake all waiters without moving time (event set, close, …)."""
        with self._cv:
            cvs = list(self._cond_waiters.values())
            self._cv.notify_all()
        self._notify_foreign(cvs)

    @staticmethod
    def _notify_foreign(cvs) -> None:
        for cv in cvs:
            with cv:
                cv.notify_all()

    def close(self) -> None:
        """Release every waiter (their virtual deadlines are treated as
        expired on the next re-check); used at simulation teardown."""
        with self._cv:
            self._closed = True
            cvs = list(self._cond_waiters.values())
            self._cv.notify_all()
        self._notify_foreign(cvs)


# --------------------------------------------------------------------- #
# process-wide installation                                             #
# --------------------------------------------------------------------- #

_clock: Clock = SystemClock()


def get_clock() -> Clock:
    return _clock


def install(clock: Clock) -> Clock:
    """Install ``clock`` process-wide; returns the previous one. Construct
    every simulated component AFTER installing — events and lease
    deadlines are created against the clock live at construction.

    Installing a VirtualClock with MM_CLOCK_DEBUG=1 arms the runtime
    clock-discipline witness (utils/clockdebug.py); installing anything
    else disarms it."""
    global _clock
    prev = _clock
    _clock = clock
    from modelmesh_tpu_torch.utils import clockdebug

    clockdebug.on_clock_installed(clock)
    return prev


@contextlib.contextmanager
def installed(clock: Clock):
    prev = install(clock)
    try:
        yield clock
    finally:
        install(prev)
        if isinstance(clock, VirtualClock):
            clock.close()


# Module-level conveniences: the call sites most modules need.

def now_ms() -> int:
    return _clock.now_ms()


def monotonic() -> float:
    return _clock.monotonic()


def sleep(seconds: float) -> None:
    _clock.sleep(seconds)
