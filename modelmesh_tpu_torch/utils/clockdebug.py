"""The port's own copy of the JAX package's ``utils/clockdebug.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

MM_CLOCK_DEBUG=1 runtime clock-discipline witness (the dynamic half
of the static ``clock-discipline`` rule — the MM_LOCK_DEBUG pattern).

The static rule proves every *annotated* wall-clock site was deliberate;
this module proves the *annotation grammar itself* is live: while a
``VirtualClock`` is installed and ``MM_CLOCK_DEBUG=1`` (read at clock
INSTALL time, so tests set the env before installing), any
``time.time/monotonic/sleep/perf_counter/*_ns`` call whose caller is
``modelmesh_tpu_torch`` code raises :class:`WallClockViolation` — unless the
calling line (or the line above) carries the same ``#: wall-clock:
<reason>`` annotation the static analyzer accepts. The two checks pin
each other: a site the static rule would flag also blows up the first
time the sim executes it, and an annotation typo that silences the
static rule without matching the grammar still raises here.

Mechanics: :func:`activate` swaps the ``time`` module's functions for
wrappers. Wrappers are pass-through for foreign callers (stdlib, pytest,
test files) and for the clock seam itself (``utils/clock.py`` and this
module); product callers are resolved by frame inspection and their
source line checked against ``WALL_CLOCK_RE`` (cached per (file, line)).
``datetime.now`` is out of scope — patching a C type's classmethod is
not worth it for a debug aid; the static rule covers it.

Keep ``WALL_CLOCK_RE`` in sync with ``tools/analysis/core.py`` — the
static and dynamic checks read the SAME grammar or they stop pinning
each other.
"""

from __future__ import annotations

import linecache
import os
import re
import sys
import threading
import time as _time

# Same grammar as tools/analysis/core.WALL_CLOCK_RE (modelmesh_tpu_torch must
# not import from tools/, so the pattern is duplicated — see module doc).
WALL_CLOCK_RE = re.compile(r"#:\s*wall-clock:\s*\S")

# Callers under this path fragment are product code and must annotate.
_PRODUCT_FRAGMENT = os.sep + "modelmesh_tpu_torch" + os.sep
# ... except the clock seam itself and this witness.
_EXEMPT_SUFFIXES = (
    os.path.join("modelmesh_tpu_torch", "utils", "clock.py"),
    os.path.join("modelmesh_tpu_torch", "utils", "clockdebug.py"),
)

_PATCH_FNS = (
    "time", "monotonic", "sleep", "perf_counter", "process_time",
    "time_ns", "monotonic_ns", "perf_counter_ns",
)


class WallClockViolation(RuntimeError):
    """Un-annotated wall-clock call from product code under a
    VirtualClock with MM_CLOCK_DEBUG=1."""


_lock = threading.Lock()
_originals: dict[str, object] = {}  #: guarded-by: _lock [rebind]
# (filename, lineno) -> line is annotated (memoized source lookups)
_annotated: dict[tuple[str, int], bool] = {}


def active() -> bool:
    return bool(_originals)


def _line_annotated(filename: str, lineno: int) -> bool:
    key = (filename, lineno)
    hit = _annotated.get(key)
    if hit is None:
        hit = any(
            WALL_CLOCK_RE.search(linecache.getline(filename, ln) or "")
            for ln in (lineno, lineno - 1)
        )
        _annotated[key] = hit
    return hit


def _check_caller(fn_name: str) -> None:
    frame = sys._getframe(2)  # wrapper -> _check_caller -> caller
    filename = frame.f_code.co_filename
    if _PRODUCT_FRAGMENT not in filename or filename.endswith(
        _EXEMPT_SUFFIXES
    ):
        return
    lineno = frame.f_lineno
    if _line_annotated(filename, lineno):
        return
    raise WallClockViolation(
        f"{filename}:{lineno}: bare time.{fn_name}() under a VirtualClock "
        f"with MM_CLOCK_DEBUG=1 — logical time reads through "
        f"utils.clock.get_clock(); a deliberate wall-clock site declares "
        f"`#: wall-clock: <reason>` on the call line "
        f"(docs/static-analysis.md)"
    )


def _make_wrapper(fn_name: str, original):
    def wrapper(*args, **kwargs):
        _check_caller(fn_name)
        return original(*args, **kwargs)

    wrapper.__name__ = fn_name
    wrapper.__qualname__ = fn_name
    wrapper.__wrapped__ = original
    return wrapper


def activate() -> None:
    """Patch the ``time`` module's clock functions with checking
    wrappers. Idempotent; no-op if already active."""
    with _lock:
        if _originals:
            return
        linecache.checkcache()  # tests write throwaway modules mid-run
        for name in _PATCH_FNS:
            original = getattr(_time, name, None)
            if original is None:
                continue
            _originals[name] = original
            setattr(_time, name, _make_wrapper(name, original))


def deactivate() -> None:
    """Restore the original ``time`` functions. Idempotent."""
    with _lock:
        for name, original in _originals.items():
            setattr(_time, name, original)
        _originals.clear()
        _annotated.clear()


def on_clock_installed(clock) -> None:
    """Hook called by ``utils.clock.install``: arm the witness while a
    VirtualClock is installed AND MM_CLOCK_DEBUG=1 (env read here, at
    install time), disarm otherwise."""
    from modelmesh_tpu_torch.utils import envs
    from modelmesh_tpu_torch.utils.clock import VirtualClock

    if isinstance(clock, VirtualClock) and envs.get_bool("MM_CLOCK_DEBUG"):
        activate()
    else:
        deactivate()
