"""The port's own copy of the JAX package's ``utils/lockdebug.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

MM_LOCK_DEBUG=1 runtime lock-order validation (the dynamic half of
``tools/analysis``'s lock-order rule).

Concurrency-heavy modules create their locks through the ``mm_lock`` /
``mm_rlock`` / ``mm_condition`` factories with a stable, canonical name
(``ClassName._attr`` — the same node names the static analyzer derives
for ``tools/analysis/lock_order.txt``). In production the factories
return plain ``threading`` primitives — zero overhead, nothing wrapped.
With ``MM_LOCK_DEBUG=1`` (read at lock creation time, so tests set the
env var before building a cluster) they return instrumented wrappers
that:

- record per-thread acquisition stacks for every held lock,
- maintain a process-wide witness graph of observed acquisition edges
  (held-lock -> acquired-lock), seeded with the static edges from
  ``tools/analysis/lock_order.txt``,
- raise ``LockOrderViolation`` — with a dump of every held lock and the
  stack it was acquired on — the moment an acquisition would create a
  cycle in that graph (the classic witness lock-order checker: a cycle
  means two code paths acquire the same pair of locks in opposite
  orders, i.e. a potential deadlock, even if this run never deadlocks).

Edges are keyed by lock *name*, not instance: two ``CacheEntry._lock``
instances share a node, and same-name acquisitions are ignored (ordering
within a homogeneous lock population is an address-ordering concern the
graph cannot express). Re-entrant acquisitions of a held name are
recorded but never edge-checked.
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Optional

_LOCK_ORDER_FILE = "tools/analysis/lock_order.txt"


class LockOrderViolation(RuntimeError):
    """An acquisition created a cycle in the lock-order witness graph."""


def enabled() -> bool:
    from modelmesh_tpu_torch.utils import envs

    try:
        return envs.get_bool("MM_LOCK_DEBUG")
    except Exception:  # noqa: BLE001 — junk value: fail open (prod default)
        return False


# --------------------------------------------------------------------- #
# witness graph                                                         #
# --------------------------------------------------------------------- #


class _Graph:
    """Directed acquisition graph with cycle-on-insert detection."""

    def __init__(self):
        # Internal bookkeeping lock — a plain primitive, never wrapped
        # (the validator must not validate itself).
        self._mu = threading.Lock()
        self._edges: dict[str, set[str]] = {}
        self._static_loaded = False

    def _load_static_locked(self) -> None:
        if self._static_loaded:
            return
        self._static_loaded = True
        import os

        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            *_LOCK_ORDER_FILE.split("/"),
        )
        try:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.split("#", 1)[0].strip()
                    if "->" not in line:
                        continue
                    outer, _, inner = (p.strip() for p in line.partition("->"))
                    if outer and inner and outer != inner:
                        self._edges.setdefault(outer, set()).add(inner)
        except OSError:
            pass  # no derived graph checked out: dynamic witness only

    def _reachable_locked(self, src: str, dst: str) -> Optional[list[str]]:
        """DFS path src -> dst through current edges, None if unreachable."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in self._edges.get(node, ()):
                if nxt == dst:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def add_edge(self, outer: str, inner: str) -> Optional[list[str]]:
        """Record outer->inner; returns the conflicting inner->..->outer
        path when the insertion would create a cycle (caller raises)."""
        if outer == inner:
            return None
        with self._mu:
            self._load_static_locked()
            if inner in self._edges.get(outer, ()):
                return None
            path = self._reachable_locked(inner, outer)
            if path is not None:
                return path
            self._edges.setdefault(outer, set()).add(inner)
            return None

    def reset(self) -> None:
        """Drop all edges and re-arm the static reload (test isolation)."""
        with self._mu:
            self._edges = {}
            self._static_loaded = False


_graph = _Graph()
_tls = threading.local()


def _held() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def held_lock_names() -> list[str]:
    """Names of locks the calling thread currently holds (debug mode)."""
    return [name for name, _ in _held()]


def dump_held() -> str:
    held = _held()
    if not held:
        return "  (no instrumented locks held)"
    out = []
    for name, stack in held:
        out.append(f"  held: {name}\n    acquired at:\n{stack}")
    return "\n".join(out)


def reset_validator() -> None:
    """Clear the witness graph (unit-test isolation helper)."""
    _graph.reset()


def _note_acquire(name: str) -> None:
    held = _held()
    reentrant = any(h == name for h, _ in held)
    if not reentrant:
        for h, _ in held:
            path = _graph.add_edge(h, name)
            if path is not None:
                raise LockOrderViolation(
                    f"lock-order violation in thread "
                    f"{threading.current_thread().name!r}: acquiring "
                    f"{name!r} while holding {h!r}, but the witness graph "
                    f"already orders {' -> '.join(path)} — two paths "
                    f"acquire this pair in opposite orders.\n"
                    f"Currently held locks:\n{dump_held()}"
                )
    stack = "".join(
        traceback.format_stack(sys._getframe(2), limit=6)
    )
    held.append((name, stack))


def _note_release(name: str) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] == name:
            del held[i]
            return


# --------------------------------------------------------------------- #
# instrumented primitives                                               #
# --------------------------------------------------------------------- #


class _DebugLock:
    """Wrapper around a plain Lock/RLock: bookkeeping + order checking.

    Implements the full Condition lock protocol (``_release_save`` /
    ``_acquire_restore`` / ``_is_owned``) so ``threading.Condition`` can
    be built over it; ``wait()`` then releases/reacquires through the
    wrapper and the held-lock bookkeeping stays truthful across waits.
    """

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            try:
                _note_acquire(self.name)
            except LockOrderViolation:
                # Never strand the primitive locked on a rejected acquire.
                self._inner.release()
                raise
        return ok

    def release(self) -> None:
        self._inner.release()
        _note_release(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        inner = self._inner
        if hasattr(inner, "locked"):
            return inner.locked()
        return self._is_owned()

    # -- Condition protocol ------------------------------------------------

    def _release_save(self):
        held = _held()
        count = sum(1 for h, _ in held if h == self.name)
        _n = 0
        while _n < count:
            _note_release(self.name)
            _n += 1
        inner = self._inner
        if hasattr(inner, "_release_save"):
            return (inner._release_save(), count)
        inner.release()
        return (None, count)

    def _acquire_restore(self, state) -> None:
        inner_state, count = state
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(inner_state)
        else:
            inner.acquire()
        # Re-push without edge-checking: raising here would return from
        # Condition.wait() with the lock in an inconsistent state. The
        # hazardous pattern (waiting while holding another lock) is the
        # static blocking-under-lock rule's job.
        held = _held()
        stack = "".join(traceback.format_stack(sys._getframe(1), limit=6))
        for _ in range(max(1, count)):
            held.append((self.name, stack))

    def _is_owned(self) -> bool:
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        # Plain Lock: emulate the stdlib Condition probe on the RAW
        # primitive (bypassing bookkeeping — the probe is not a real
        # acquisition and must not record edges).
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def __repr__(self) -> str:
        return f"<DebugLock {self.name} over {self._inner!r}>"


# --------------------------------------------------------------------- #
# factories                                                             #
# --------------------------------------------------------------------- #


def mm_lock(name: str):
    """A ``threading.Lock`` — instrumented under MM_LOCK_DEBUG=1 and/or
    MM_RACE_DEBUG=1 (utils/racedebug.py); plain otherwise."""
    from modelmesh_tpu_torch.utils import racedebug

    lock = _DebugLock(name, threading.Lock()) if enabled() \
        else threading.Lock()
    return racedebug.maybe_wrap_lock(name, lock)


def mm_rlock(name: str):
    """A ``threading.RLock`` — instrumented under MM_LOCK_DEBUG=1 and/or
    MM_RACE_DEBUG=1; plain otherwise."""
    from modelmesh_tpu_torch.utils import racedebug

    lock = _DebugLock(name, threading.RLock()) if enabled() \
        else threading.RLock()
    return racedebug.maybe_wrap_lock(name, lock)


def mm_condition(name: str, lock=None):
    """A ``threading.Condition`` whose underlying lock is instrumented
    under MM_LOCK_DEBUG=1 and/or MM_RACE_DEBUG=1. Pass ``lock`` to share
    an existing (possibly already-instrumented) lock, matching
    ``threading.Condition(lock)`` — a shared lock that is already
    race-wrapped is reused as-is so the release->acquire clock channel
    stays unified."""
    from modelmesh_tpu_torch.utils import racedebug

    if lock is None:
        if enabled():
            lock = _DebugLock(name, threading.RLock())
        elif racedebug.enabled():
            lock = threading.RLock()
    if lock is not None:
        lock = racedebug.maybe_wrap_lock(name, lock)
    return threading.Condition(lock)
