"""The port's own copy of the JAX package's ``utils/racedebug.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

MM_RACE_DEBUG=1 vector-clock happens-before data-race sanitizer (the
dynamic half of ``tools/analysis``'s shared-state escape rule).

A FastTrack-lite detector: every thread carries a vector clock, and the
synchronization primitives the repo already funnels through narrow
factories become the happens-before edges —

- ``mm_lock`` / ``mm_rlock`` / ``mm_condition`` (utils/lockdebug.py):
  release publishes the holder's clock into the lock, acquire joins it
  (Condition ``wait`` releases/reacquires through the same wrapper, so
  cv-mediated handoffs are ordered too);
- thread create/join: ``Thread.start`` snapshots the parent's clock for
  the child to adopt at bootstrap, ``join`` adopts the child's final
  clock (``threading.Timer`` is a ``Thread`` subclass, so
  ``SystemClock.call_later`` rides the same patch);
- pool submit -> task run (utils/pool.py) and ``VirtualClock``
  ``call_later`` schedule -> fire carry explicit tokens.

Classes opt in with ``@racedebug.tracked("field", ...)``: under
MM_RACE_DEBUG=1 their instances are re-classed at construction onto a
shim subclass whose ``__setattr__`` (and, for fields listed in
``reads=...``, ``__getattribute__``) records per-field access epochs
and raises ``DataRaceViolation`` — carrying BOTH conflicting stacks —
the moment two accesses are unordered by the happens-before relation.
Every violation is also appended to a process-wide log so test
fixtures can assert the run stayed clean (``violations()``).

Default tracking is WRITE-ONLY: this codebase deliberately reads some
shared fields lock-free (GIL-atomic snapshots, ``[rebind]`` guarded
fields), and flagging those by default would drown the signal. Name a
field in ``reads=`` only when its reads are also contractually
lock-ordered.

Production overhead is zero by construction: with the env var unset the
lock factories return plain ``threading`` primitives, ``tracked``
classes keep their original ``__setattr__``/``__getattribute__``, the
``Thread`` methods stay unpatched, and the pool/clock hooks are a
single module-flag check (see TestRaceDebugProductionMode).

Like MM_LOCK_DEBUG, the env var is read at *creation* time — set it
before constructing locks and tracked instances. Patching arms lazily
on the first enabled creation; ``deactivate()`` restores everything
(test isolation).
"""

from __future__ import annotations

import itertools
import sys
import threading
import traceback
from typing import Optional


class DataRaceViolation(RuntimeError):
    """Two unsynchronized accesses to a tracked field were concurrent
    (neither happens-before the other)."""


def enabled() -> bool:
    from modelmesh_tpu_torch.utils import envs

    try:
        return envs.get_bool("MM_RACE_DEBUG")
    except Exception:  # noqa: BLE001 — junk value: fail open (prod default)
        return False


# --------------------------------------------------------------------- #
# vector clocks                                                         #
# --------------------------------------------------------------------- #

# One bookkeeping lock for all sanitizer state. Debug-only tool: the
# serialization cost is the price of a witness that never lies about
# ordering (and must never deadlock with product locks — it is a plain
# primitive, never wrapped, and nothing is called while holding it).
_mu = threading.Lock()
_active = False
_tls = threading.local()
_tid_counter = itertools.count(1)
_violations: list[DataRaceViolation] = []
_orig_thread_methods: dict = {}


def active() -> bool:
    return _active


def violations() -> list[DataRaceViolation]:
    """Violations recorded since the last activate()/clear()."""
    with _mu:
        return list(_violations)


def clear_violations() -> None:
    with _mu:
        del _violations[:]


def _state():
    """(tid, vc) of the calling thread. Thread ids are assigned from a
    process-wide counter on first touch — NOT ``get_ident()``, which the
    OS reuses after a thread dies and would resurrect a dead thread's
    epochs."""
    tid = getattr(_tls, "tid", None)
    if tid is None:
        tid = _tls.tid = next(_tid_counter)
        _tls.vc = {tid: 1}
    return tid, _tls.vc


def _tick() -> None:
    tid, vc = _state()
    vc[tid] += 1


def _join(other: dict) -> None:
    _tid, vc = _state()
    for t, c in other.items():
        if vc.get(t, 0) < c:
            vc[t] = c


def _snapshot() -> dict:
    _tid, vc = _state()
    return dict(vc)


# --------------------------------------------------------------------- #
# task tokens: pool submit -> run, call_later schedule -> fire          #
# --------------------------------------------------------------------- #


def task_created() -> Optional[dict]:
    """Capture the creator's clock for a task handed to another thread.
    Near-zero cost when the sanitizer is idle (one module-flag check) —
    safe on hot paths like pool.submit."""
    if not _active:
        return None
    snap = _snapshot()
    _tick()
    return snap


def task_begin(token: Optional[dict]) -> None:
    """Adopt a creator's clock at the start of the task body."""
    if token is not None and _active:
        _join(token)


# --------------------------------------------------------------------- #
# thread create / join edges                                            #
# --------------------------------------------------------------------- #


def activate() -> None:
    """Arm the sanitizer: patch Thread start/bootstrap/join. Idempotent;
    called lazily from every creation-time hook when MM_RACE_DEBUG=1."""
    global _active
    with _mu:
        if _active:
            return
        _orig_thread_methods["start"] = threading.Thread.start
        _orig_thread_methods["boot"] = threading.Thread._bootstrap_inner
        _orig_thread_methods["join"] = threading.Thread.join

        def start(self, *a, **k):
            if _active:
                self._mm_race_token = task_created()
            return _orig_thread_methods["start"](self, *a, **k)

        def _bootstrap_inner(self):
            tok = getattr(self, "_mm_race_token", None)
            if tok is not None:
                task_begin(tok)
            try:
                _orig_thread_methods["boot"](self)
            finally:
                if tok is not None and _active:
                    _tick()
                    self._mm_race_final = _snapshot()

        def join(self, timeout=None):
            r = _orig_thread_methods["join"](self, timeout)
            if _active and not self.is_alive():
                fin = getattr(self, "_mm_race_final", None)
                if fin is not None:
                    _join(fin)
            return r

        threading.Thread.start = start
        threading.Thread._bootstrap_inner = _bootstrap_inner
        threading.Thread.join = join
        del _violations[:]
        _active = True


def deactivate() -> None:
    """Disarm and unpatch (test isolation). Tracked instances keep their
    shim class but every hook body is behind the _active flag."""
    global _active
    with _mu:
        if not _active:
            return
        _active = False
        threading.Thread.start = _orig_thread_methods.pop("start")
        threading.Thread._bootstrap_inner = _orig_thread_methods.pop("boot")
        threading.Thread.join = _orig_thread_methods.pop("join")


# --------------------------------------------------------------------- #
# lock release -> acquire edges                                         #
# --------------------------------------------------------------------- #


class _RaceLock:
    """Happens-before wrapper over a Lock/RLock (plain or lockdebug's
    _DebugLock — the two compose). Release publishes the holder's clock
    into the lock; acquire joins it. Implements the Condition lock
    protocol so cv waits release/reacquire through the wrapper."""

    __slots__ = ("name", "_inner", "_vc")

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner
        self._vc: dict = {}

    def _publish(self) -> None:
        if _active:
            with _mu:
                self._vc = _snapshot()
            _tick()

    def _adopt(self) -> None:
        if _active:
            with _mu:
                vc = self._vc
            _join(vc)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._adopt()
        return ok

    def release(self) -> None:
        self._publish()
        self._inner.release()

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
        self._publish()
        inner = self._inner
        if hasattr(inner, "_release_save"):
            return inner._release_save()
        inner.release()
        return None

    def _acquire_restore(self, state) -> None:
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(state)
        else:
            inner.acquire()
        self._adopt()

    def _is_owned(self) -> bool:
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def __repr__(self) -> str:
        return f"<RaceLock {self.name} over {self._inner!r}>"


def maybe_wrap_lock(name: str, lock):
    """Factory hook (utils/lockdebug.py): wrap under MM_RACE_DEBUG=1,
    return unchanged otherwise. Never double-wraps — a Condition built
    over an already-wrapped lock must SHARE its clock channel, or the
    release->acquire edge splits across two wrappers and vanishes."""
    if isinstance(lock, _RaceLock) or not enabled():
        return lock
    activate()
    return _RaceLock(name, lock)


# --------------------------------------------------------------------- #
# tracked fields                                                        #
# --------------------------------------------------------------------- #

_EPOCHS = "_mm_race_epochs"
_shim_cache: dict[type, type] = {}


def _stack() -> str:
    return "".join(traceback.format_stack(sys._getframe(3), limit=8))


def _raise(kind: str, obj, name: str, other_stack: str) -> None:
    here = "".join(traceback.format_stack(sys._getframe(2), limit=8))
    err = DataRaceViolation(
        f"data race on {type(obj).__name__}.{name} ({kind}): thread "
        f"{threading.current_thread().name!r} is unordered with the "
        f"previous access.\n--- this access:\n{here}"
        f"--- conflicting access:\n{other_stack}"
    )
    _violations.append(err)
    raise err


def _on_write(obj, name: str) -> None:
    tid, vc = _state()
    with _mu:
        epochs = object.__getattribute__(obj, _EPOCHS)
        entry = epochs.get(name)
        if entry is not None:
            wtid, wclk, wstack = entry["w"]
            if wtid != tid and vc.get(wtid, 0) < wclk:
                _raise("write-write", obj, name, wstack)
            for rtid, (rclk, rstack) in entry["r"].items():
                if rtid != tid and vc.get(rtid, 0) < rclk:
                    _raise("read-write", obj, name, rstack)
        epochs[name] = {"w": (tid, vc[tid], _stack()), "r": {}}
    _tick()


def _on_read(obj, name: str) -> None:
    tid, vc = _state()
    with _mu:
        epochs = object.__getattribute__(obj, _EPOCHS)
        entry = epochs.get(name)
        if entry is not None:
            wtid, wclk, wstack = entry["w"]
            if wtid != tid and vc.get(wtid, 0) < wclk:
                _raise("write-read", obj, name, wstack)
            entry["r"][tid] = (vc[tid], _stack())
    _tick()


def _epochs_of(obj):
    """The instance's epoch table, or None while construction is still
    in flight (the table is armed only after ``__init__`` returns)."""
    try:
        return object.__getattribute__(obj, _EPOCHS)
    except AttributeError:
        return None


def _shim_for(cls: type, fields: frozenset, reads: frozenset) -> type:
    shim = _shim_cache.get(cls)
    if shim is not None:
        return shim
    base_setattr = cls.__setattr__

    def __setattr__(self, name, value):  # noqa: N807 — shim method
        if _active and name in fields and _epochs_of(self) is not None:
            _on_write(self, name)
        base_setattr(self, name, value)

    ns = {"__setattr__": __setattr__, "__slots__": ()}
    if getattr(cls, "__dictoffset__", 0) == 0:
        # All-slots product class (e.g. RouteCache): the shim carries the
        # epoch table in a slot of its own. Instances are BORN as the
        # shim (see tracked()'s __new__ hook), so the layout difference
        # never meets a __class__ reassignment.
        ns["__slots__"] = (_EPOCHS,)
    if reads:
        def __getattribute__(self, name):  # noqa: N807 — shim method
            if _active and name in reads and _epochs_of(self) is not None:
                _on_read(self, name)
            return object.__getattribute__(self, name)

        ns["__getattribute__"] = __getattribute__
    shim = type(f"_MMRaceTracked_{cls.__name__}", (cls,), ns)
    # The shim is meant to be invisible: report violations (and repr) under
    # the product class's own name.
    shim.__name__ = cls.__name__
    shim.__qualname__ = cls.__qualname__
    _shim_cache[cls] = shim
    return shim


def tracked(*fields: str, reads: tuple = ()):
    """Class decorator: under MM_RACE_DEBUG=1, instances record
    happens-before epochs for ``fields`` writes (and ``reads`` reads).
    Production classes are returned untouched — ``__new__`` gains one
    disabled-flag check and nothing else. Construction itself is exempt
    (publication is a happens-before edge): instances are born as the
    tracking shim, but the epoch table is armed only after ``__init__``
    returns."""
    fset = frozenset(fields)
    rset = frozenset(reads)
    if not rset <= fset:
        raise ValueError(f"reads {sorted(rset - fset)} not in fields")

    def deco(cls: type) -> type:
        orig_new = cls.__new__
        orig_init = cls.__init__

        def __new__(klass, *a, **k):  # noqa: N807 — wrapped ctor
            if klass is cls and enabled():
                activate()
                klass = _shim_for(cls, fset, rset)
            if orig_new is object.__new__:
                return object.__new__(klass)
            return orig_new(klass, *a, **k)

        def __init__(self, *a, **k):  # noqa: N807 — wrapped ctor
            orig_init(self, *a, **k)
            if _shim_cache.get(cls) is type(self):
                object.__setattr__(self, _EPOCHS, {})

        __new__.__wrapped__ = orig_new
        __init__.__wrapped__ = orig_init
        cls.__new__ = __new__
        cls.__init__ = __init__
        cls.__mm_race_fields__ = fset
        cls.__mm_race_reads__ = rset
        return cls

    return deco
