"""Device mesh for the sharded placement solve, and its collectives.

Port of the solver half of ``modelmesh_tpu/parallel/mesh.py``. Axis
convention, as there:

- ``"mdl"`` shards the model axis (rows of the cost matrix), the long
  dimension and the primary sharding axis;
- ``"inst"`` optionally shards the instance axis (columns) for cost
  assembly and the dense column work; rows are gathered before top-k.

One controlling process drives every shard, as the reference's leader
runs its sharded solve inside one process over its host's devices. A
``Mesh`` keeps one worker thread per shard for its life; ``shard_map``
runs a function once per shard, each in its own thread with
``torch.cuda.device`` set to the shard's device. Inside a shard the module
functions mirror ``jax.lax``: ``axis_index``, ``psum``, ``pmax``, ``pmin``
and ``all_gather``, read from a thread-local shard context.

A collective is an exchange through the mesh's slot table: each shard puts
its tensor in its slot and waits at a barrier; each then reads the slots
of its axis group in rank order, copies them to its own device, and
reduces them in that order there, so every shard holds the same bits and
every host gate (``device.item``) takes the same branch on every shard; a
second barrier guards the table's reuse. The barrier has a timeout, and an
exception in any shard aborts it: the caller gets the first exception,
never a hang. On an axis of size 1 every collective is the identity.

Shards on one device share its current stream, so a read enqueued after
the barrier is ordered after the write enqueued before it; a copy across
devices (``Tensor.to``) orders itself against both devices' current
streams. The GIL serializes the shards' launches: a mesh of 8 shards on
one card does the single-device work in 8 times the launches.

``PROBLEM_LAYOUT`` is the one place that says how each
``PlacementProblem`` field splits over a mesh: model-axis vectors on
``mdl``, instance-axis vectors on ``inst``, matrices on both.
"""

from __future__ import annotations

import queue
import threading
import weakref
from typing import NamedTuple, Sequence

import torch

MODEL_AXIS = "mdl"
INSTANCE_AXIS = "inst"
AXES = (MODEL_AXIS, INSTANCE_AXIS)

# Seconds a shard waits at a collective for the others before the mesh
# gives up (a shard that skipped a collective, or hung).
COLLECTIVE_TIMEOUT_S = 300.0

# The mesh axis each dimension of a PlacementProblem field is split on.
PROBLEM_LAYOUT = {
    "sizes": (MODEL_AXIS,),
    "copies": (MODEL_AXIS,),
    "rates": (MODEL_AXIS,),
    "loaded": (MODEL_AXIS, INSTANCE_AXIS),
    "feasible": (MODEL_AXIS, INSTANCE_AXIS),
    "capacity": (INSTANCE_AXIS,),
    "reserved": (INSTANCE_AXIS,),
    "lru_age": (INSTANCE_AXIS,),
    "busyness": (INSTANCE_AXIS,),
    "zone": (INSTANCE_AXIS,),
    "preferred": (MODEL_AXIS, INSTANCE_AXIS),
}


class ShardContext(NamedTuple):
    """What a shard's thread knows about itself while ``shard_map`` runs
    its function."""

    mesh: "Mesh"
    rank: int
    coords: dict     # axis name -> this shard's index on it
    device: torch.device


_local = threading.local()


def _serve(tasks: "queue.SimpleQueue") -> None:
    """A shard's worker: run tasks until the None sentinel."""
    while True:
        task = tasks.get()
        if task is None:
            return
        task()
        del task  # no reference to the mesh while idle


def _stop(tasks_list) -> None:
    for tasks in tasks_list:
        tasks.put(None)


class Mesh:
    """A (mdl, inst) grid of devices; rank ``i * n_inst + j`` is the shard
    at ``mdl`` index i and ``inst`` index j. ``shape`` maps each axis name
    to its size; ``devices`` lists the shards' devices in rank order (one
    device may hold several shards)."""

    def __init__(self, devices: Sequence[torch.device], shape):
        n_mdl, n_inst = (int(d) for d in shape)
        if n_mdl < 1 or n_inst < 1 or n_mdl * n_inst != len(devices):
            raise ValueError(
                f"mesh shape {tuple(shape)} does not hold {len(devices)} "
                "devices"
            )
        self.devices = [torch.device(d) for d in devices]
        self.shape = {MODEL_AXIS: n_mdl, INSTANCE_AXIS: n_inst}
        self.size = n_mdl * n_inst
        self.timeout = COLLECTIVE_TIMEOUT_S
        # Each axis group's ranks in axis order, by the rank of a member.
        self._groups = {
            MODEL_AXIS: [[self.rank_of(k, j) for k in range(n_mdl)]
                         for i, j in map(self.coords, range(self.size))],
            INSTANCE_AXIS: [[self.rank_of(i, k) for k in range(n_inst)]
                            for i, j in map(self.coords, range(self.size))],
        }
        self._slots: list = [None] * self.size
        self._barrier = threading.Barrier(self.size, timeout=self.timeout)
        self._run_lock = threading.Lock()
        self._queues = None
        self._threads: list[threading.Thread] = []

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"

    def coords(self, rank: int) -> tuple[int, int]:
        """(mdl index, inst index) of ``rank``."""
        return divmod(rank, self.shape[INSTANCE_AXIS])

    def rank_of(self, i: int, j: int) -> int:
        return i * self.shape[INSTANCE_AXIS] + j

    def block_range(self, rank: int, axis: str, extent: int) -> tuple:
        """[start, stop) of ``rank``'s block of a dimension of ``extent``
        split on ``axis``; raises ValueError when the axis does not divide
        it."""
        parts = self.shape[axis]
        if extent % parts:
            raise ValueError(
                f"mesh {self.shape} does not divide {extent} on {axis!r}"
            )
        blk = extent // parts
        k = self.coords(rank)[AXES.index(axis)]
        return k * blk, (k + 1) * blk

    def block(self, rank: int, t: torch.Tensor, axes) -> torch.Tensor:
        """``rank``'s block of ``t``, whose dimension d is split on
        ``axes[d]`` (a view)."""
        idx = tuple(slice(*self.block_range(rank, ax, t.shape[d]))
                    for d, ax in enumerate(axes))
        return t[idx]

    def threads(self) -> list[int]:
        """The worker threads' idents in rank order (empty before the
        first run)."""
        return [t.ident for t in self._threads]

    def _start(self) -> None:
        if self._queues is not None:
            return
        self._queues = [queue.SimpleQueue() for _ in range(self.size)]
        for rank, tasks in enumerate(self._queues):
            t = threading.Thread(target=_serve, args=(tasks,), daemon=True,
                                 name=f"mesh-shard-{rank}")
            t.start()
            self._threads.append(t)
        self._finalizer = weakref.finalize(self, _stop, self._queues)

    def close(self) -> None:
        """Stop the worker threads (a later run starts new ones)."""
        with self._run_lock:
            if self._queues is None:
                return
            self._finalizer()
            for t in self._threads:
                t.join()
            self._queues, self._threads = None, []

    def run(self, fn, args: Sequence[Sequence] = (), kwargs=None) -> list:
        """``fn(*args_r, **kwargs)`` once per shard r, each on its worker
        thread under its shard context; ``args`` holds one sequence per
        positional argument, with one entry per shard in rank order.
        Returns the results in rank order, or raises the first exception a
        shard raised."""
        if getattr(_local, "ctx", None) is not None:
            raise RuntimeError("shard_map called inside a shard")
        kwargs = kwargs or {}
        for a in args:
            if len(a) != self.size:
                raise ValueError(
                    f"a sharded argument has {len(a)} entries for "
                    f"{self.size} shards"
                )
        with self._run_lock:
            self._start()
            results = [None] * self.size
            errors: list[BaseException] = []
            err_lock = threading.Lock()
            done = [threading.Event() for _ in range(self.size)]

            def task(rank):
                i, j = self.coords(rank)
                dev = self.devices[rank]
                _local.ctx = ShardContext(
                    self, rank, {MODEL_AXIS: i, INSTANCE_AXIS: j}, dev)
                try:
                    shard_args = [a[rank] for a in args]
                    if dev.type == "cuda":
                        with torch.cuda.device(dev):
                            results[rank] = fn(*shard_args, **kwargs)
                    else:
                        results[rank] = fn(*shard_args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — to the caller
                    with err_lock:
                        errors.append(e)
                    self._barrier.abort()
                finally:
                    _local.ctx = None
                    done[rank].set()

            for rank, tasks in enumerate(self._queues):
                tasks.put(lambda rank=rank: task(rank))
            for ev in done:
                ev.wait()
            self._slots = [None] * self.size
            if errors:
                self._barrier.reset()
                first = next(
                    (e for e in errors
                     if not isinstance(e, threading.BrokenBarrierError)),
                    None,
                )
                if first is None:
                    raise TimeoutError(
                        f"a shard waited {self.timeout} s at a collective "
                        "for the others"
                    ) from errors[0]
                raise first
            return results

    def _exchange(self, ctx: ShardContext, x, axis: str) -> list:
        """The values of ``ctx``'s axis group, in axis order, each on
        ``ctx.device`` (tensors, or tuples of tensors)."""
        self._slots[ctx.rank] = x
        self._barrier.wait()
        parts = [_to(self._slots[r], ctx.device)
                 for r in self._groups[axis][ctx.rank]]
        self._barrier.wait()
        return parts


def _to(x, device):
    if isinstance(x, tuple):
        return tuple(_to(t, device) for t in x)
    return x if x.device == device else x.to(device)


def make_mesh(shape: Sequence[int] | None = None,
              devices: Sequence | None = None) -> Mesh:
    """A (mdl, inst) mesh. ``devices=None`` means every CUDA device (and
    raises without one); a list may name one device more than once, one
    entry per shard (e.g. ``["cpu"] * 8``). ``shape=None`` puts every
    device on the model axis."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass devices=[...] (e.g. "
                "['cpu'] * 8) to build a mesh on the host"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if shape is None:
        shape = (len(devices), 1)
    return Mesh(devices, shape)


def shard_map(fn, mesh: Mesh):
    """``fn`` run once per shard of ``mesh``: the returned callable takes
    one sequence per positional argument (an entry per shard, in rank
    order) and keyword arguments passed to every shard as they are, and
    returns the shards' results in rank order."""

    def run(*args, **kwargs):
        return mesh.run(fn, args, kwargs)

    return run


def _ctx() -> ShardContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError("a mesh collective outside shard_map")
    return ctx


def axis_index(axis: str) -> int:
    """This shard's index on ``axis``."""
    return _ctx().coords[axis]


def axis_size(axis: str) -> int:
    """The size of ``axis`` of the mesh this shard belongs to."""
    return _ctx().mesh.shape[axis]


def _reduce(x: torch.Tensor, axis: str, op) -> torch.Tensor:
    ctx = _ctx()
    if ctx.mesh.shape[axis] == 1:
        return x
    parts = ctx.mesh._exchange(ctx, x, axis)
    out = parts[0]
    for p in parts[1:]:
        out = op(out, p)
    return out


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, added in axis order."""
    return _reduce(x, axis, torch.add)


def pmax(x: torch.Tensor, axis: str) -> torch.Tensor:
    return _reduce(x, axis, torch.maximum)


def pmin(x: torch.Tensor, axis: str) -> torch.Tensor:
    return _reduce(x, axis, torch.minimum)


def all_gather(x: torch.Tensor, axis: str, dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """The group's ``x`` in axis order, concatenated along ``dim``
    (``tiled``) or stacked on a new ``dim``."""
    ctx = _ctx()
    if ctx.mesh.shape[axis] == 1:
        return x if tiled else x.unsqueeze(dim)
    parts = ctx.mesh._exchange(ctx, x, axis)
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


class AxisSum:
    """The sum over the row blocks on one mesh axis, as the single-device
    ops take it (``col_psum``, ``axis_psum``): called on a tensor it is
    ``psum``; ``combine(fn, *partials)`` gathers each of ``partials`` (the
    block partials of a kernel's column reduction, rows along dim 0) in
    axis order in one exchange and runs ``fn`` (the kernel's fixed-order
    combine) once over all of them."""

    def __init__(self, axis: str):
        self.axis = axis

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return psum(x, self.axis)

    def combine(self, fn, *partials):
        ctx = _ctx()
        if ctx.mesh.shape[self.axis] == 1:
            return fn(*partials)
        groups = ctx.mesh._exchange(ctx, tuple(partials), self.axis)
        return fn(*(torch.cat(parts, 0) for parts in zip(*groups)))
