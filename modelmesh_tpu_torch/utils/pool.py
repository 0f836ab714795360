"""The port's own copy of the JAX package's ``utils/pool.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Bounded daemon-thread worker pool for fire-and-forget janitorial work.

``concurrent.futures.ThreadPoolExecutor`` is the wrong tool for cleanup
paths that may block on a KV outage: its workers are non-daemon and
joined by an atexit hook, so one wedged task keeps the whole process
alive at exit. The old alternative — a thread per task — has the
opposite failure: a registry wipe of a full cache spawns hundreds of
concurrent threads (reference runs such cleanup on a shared pool,
ModelMesh.java:2807-2814).

This pool is the narrow middle: at most ``max_workers`` daemon threads,
lazily started, unbounded submit queue, best-effort shutdown. Tasks are
fire-and-forget (no futures); exceptions are logged and swallowed.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable

from modelmesh_tpu_torch.utils import racedebug

log = logging.getLogger(__name__)

_SENTINEL = object()


class BoundedDaemonPool:
    def __init__(self, max_workers: int, name: str = "pool") -> None:
        if max_workers < 1:
            raise ValueError(f"max_workers must be >= 1, got {max_workers}")
        self._max = max_workers
        self._name = name
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._workers: list[threading.Thread] = []
        self._closed = False
        # Queued + running tasks. The deterministic sim's quiesce reads
        # this to know when async janitorial work (deregisters, unloads)
        # has actually settled — virtual time alone can't tell, because
        # these tasks run on wall-scheduled threads.
        self._pending = 0  #: guarded-by: _lock

    def submit(self, fn: Callable, *args) -> bool:
        """Enqueue ``fn(*args)``; returns False if the pool is shut down.
        Never blocks: the queue is unbounded, concurrency is what's capped.
        """
        with self._lock:
            if self._closed:
                return False
            self._pending += 1
            # MM_RACE_DEBUG submit->run happens-before edge; None (one
            # flag check) when the sanitizer is idle.
            self._q.put((fn, args, racedebug.task_created()))
            # Lazy spawn: one worker per queued task until the cap, so an
            # idle instance holds no threads and a burst gets parallelism.
            if len(self._workers) < self._max:
                t = threading.Thread(
                    target=self._run,
                    name=f"{self._name}-{len(self._workers)}",
                    daemon=True,
                )
                self._workers.append(t)
                t.start()
        return True

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            fn, args, race_token = item
            try:
                racedebug.task_begin(race_token)
                fn(*args)
            except Exception:  # noqa: BLE001 — janitorial: log, keep serving
                log.exception("%s task %r failed", self._name, fn)
            finally:
                with self._lock:
                    self._pending -= 1

    def shutdown(self) -> None:
        """Stop accepting work and release idle workers. Running tasks are
        not interrupted, but workers are daemon threads — a task wedged on
        a dead KV cannot block interpreter exit."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for _ in self._workers:
                self._q.put(_SENTINEL)

    @property
    def active_workers(self) -> int:
        with self._lock:
            return sum(t.is_alive() for t in self._workers)

    @property
    def pending(self) -> int:
        """Tasks queued or running (0 = the pool is idle)."""
        with self._lock:
            return self._pending
