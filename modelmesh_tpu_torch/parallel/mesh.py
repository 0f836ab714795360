"""Device meshes, their collectives, and the serving mesh.

Port of ``modelmesh_tpu/parallel/mesh.py``. A ``Mesh`` has named axes.
The sharded placement solve runs on the 2-D solver grid, as there:

- ``"mdl"`` shards the model axis (rows of the cost matrix), the long
  dimension and the primary sharding axis;
- ``"inst"`` optionally shards the instance axis (columns) for cost
  assembly and the dense column work; rows are gathered before top-k.

The model runtime runs on 1-D meshes: ``"seq"`` (ring attention,
``parallel/ring_attention.py``), ``"exp"`` (the expert-parallel FFN,
``parallel/moe.py``) and the serving mesh on ``"mdl"``, over which
``shard_params`` splits a model's weights.

One controlling process drives every shard, as the reference's leader
runs its sharded solve inside one process over its host's devices. A
``Mesh`` keeps one worker thread per shard for its life; ``shard_map``
runs a function once per shard, each in its own thread with
``torch.cuda.device`` set to the shard's device. Inside a shard the module
functions mirror ``jax.lax``: ``axis_index``, ``psum``, ``pmax``, ``pmin``,
``all_gather``, ``all_to_all`` and ``ppermute``, read from a thread-local
shard context. Each mesh counts the collectives its shards ran, by kind
(``Mesh.collectives``).

A collective is an exchange through the mesh's slot table: each shard puts
its tensor in its slot and waits at a barrier; each then reads the slots
of its axis group in rank order (``all_to_all`` and ``ppermute`` only the
parts addressed to it), copies them to its own device, and
reduces them in that order there, so every shard holds the same bits and
every host gate (``device.item``) takes the same branch on every shard; a
second barrier guards the table's reuse.

The shards take turns: one runs at a time, in rank order, from its start
or a barrier to its next barrier or its return, and then hands the turn
to the next. A barrier passes when every shard has reached it. So the
shards never contend for the interpreter lock or a device's launch path:
threads that ran at once released and took back the lock at every
launch, which cost several times the launch itself. The device runs each
shard's work asynchronously as before. A shard waiting for its turn has
a timeout, and an exception in any shard breaks the run: the caller gets
the first exception, never a hang. On an axis of size 1 every collective
is the identity.

Shards on one device share its current stream, so a read enqueued after
the barrier is ordered after the write enqueued before it; a copy across
devices (``Tensor.to``) orders itself against both devices' current
streams. A mesh of 8 shards on one card does the single-device work in 8
times the launches. ``run`` holds the mesh for one call at a time:
callers on several threads take turns.

``PROBLEM_LAYOUT`` is the one place that says how each
``PlacementProblem`` field splits over a mesh: model-axis vectors on
``mdl``, instance-axis vectors on ``inst``, matrices on both.
"""

from __future__ import annotations

import math
import queue
import threading
import time
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
    """A grid of devices with named axes, ``axes`` (default the solver's
    ``(mdl, inst)``) of sizes ``shape``, ranked row-major: on the solver's
    grid rank ``i * n_inst + j`` is the shard at ``mdl`` index i and
    ``inst`` index j. ``shape`` maps each axis name to its size;
    ``devices`` lists the shards' devices in rank order (one device may
    hold several shards). ``collectives`` counts the collectives the
    shards ran, by kind, one per call on every shard."""

    def __init__(self, devices: Sequence[torch.device], shape,
                 axes: Sequence[str] = AXES):
        sizes = tuple(int(d) for d in shape)
        axes = tuple(axes)
        if (len(sizes) != len(axes) or len(set(axes)) != len(axes)
                or min(sizes, default=0) < 1
                or math.prod(sizes) != len(devices)):
            raise ValueError(
                f"mesh shape {tuple(shape)} on axes {axes} does not hold "
                f"{len(devices)} devices"
            )
        self.devices = [torch.device(d) for d in devices]
        self.axes = axes
        self.shape = dict(zip(axes, sizes))
        self.size = len(self.devices)
        self.timeout = COLLECTIVE_TIMEOUT_S
        self.collectives: dict[str, int] = {}
        # Each axis group's ranks in axis order, by the rank of a member.
        self._groups = {}
        for a, axis in enumerate(axes):
            groups = []
            for rank in range(self.size):
                idx = list(self.coords(rank))
                groups.append([self.rank_of(*idx[:a], k, *idx[a + 1:])
                               for k in range(sizes[a])])
            self._groups[axis] = groups
        self._slots: list = [None] * self.size
        # The turns (``_sync``): the rank that may run is the one whose
        # ``_go`` event is set; the state below is guarded by _turn_lock.
        self._go = [threading.Event() for _ in range(self.size)]
        self._turn_lock = threading.Lock()
        self._gen = 0              # barriers passed in this run
        self._arrived = 0          # shards at the current barrier
        self._active = [False] * self.size   # shards not yet returned
        self._broken = False
        self._run_lock = threading.Lock()
        self._queues = None
        self._threads: list[threading.Thread] = []

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"

    def coords(self, rank: int) -> tuple:
        """``rank``'s index on each axis, in axis order (on the solver's
        grid: (mdl index, inst index))."""
        idx = []
        for axis in reversed(self.axes):
            rank, k = divmod(rank, self.shape[axis])
            idx.append(k)
        return tuple(reversed(idx))

    def rank_of(self, *idx: int) -> int:
        rank = 0
        for axis, k in zip(self.axes, idx):
            rank = rank * self.shape[axis] + k
        return rank

    def group(self, axis: str, rank: int = 0) -> list[int]:
        """The ranks of ``rank``'s group on ``axis``, in axis order."""
        return list(self._groups[axis][rank])

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
        k = self.coords(rank)[self.axes.index(axis)]
        return k * blk, (k + 1) * blk

    def block(self, rank: int, t: torch.Tensor, axes) -> torch.Tensor:
        """``rank``'s block of ``t``, whose dimension d is split on
        ``axes[d]`` (``None``: whole; a view)."""
        idx = tuple(slice(None) if ax is None
                    else slice(*self.block_range(rank, ax, t.shape[d]))
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
                dev = self.devices[rank]
                _local.ctx = ShardContext(
                    self, rank, dict(zip(self.axes, self.coords(rank))),
                    dev)
                try:
                    self._wait_turn(rank, -1)
                    shard_args = [a[rank] for a in args]
                    if dev.type == "cuda":
                        with torch.cuda.device(dev):
                            results[rank] = fn(*shard_args, **kwargs)
                    else:
                        results[rank] = fn(*shard_args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — to the caller
                    with err_lock:
                        errors.append(e)
                    self._break()
                finally:
                    _local.ctx = None
                    self._finish(rank)
                    done[rank].set()

            self._reset_turns()
            for rank, tasks in enumerate(self._queues):
                tasks.put(lambda rank=rank: task(rank))
            for ev in done:
                ev.wait()
            self._slots = [None] * self.size
            if errors:
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

    def _exchange(self, ctx: ShardContext, x, axis: str, take=None) -> list:
        """The values of ``ctx``'s axis group, in axis order, each on
        ``ctx.device`` (tensors, or tuples of tensors). With ``take``, the
        k-th member's value is ``take(k, value)`` instead (``None``: this
        shard reads nothing of it), and only that is copied."""
        self._slots[ctx.rank] = x
        self._sync(ctx.rank)
        parts = []
        for k, r in enumerate(self._groups[axis][ctx.rank]):
            v = self._slots[r] if take is None else take(k, self._slots[r])
            parts.append(None if v is None else _to(v, ctx.device))
        self._sync(ctx.rank)
        return parts

    # -- turns: the shards of a run execute one at a time, in rank order,
    # each from its start or a barrier to its next barrier or its return.

    def _reset_turns(self) -> None:
        with self._turn_lock:
            self._gen, self._arrived, self._broken = 0, 0, False
            self._active = [True] * self.size
        for go in self._go:
            go.clear()
        self._go[0].set()

    def _next_active(self, rank: int):
        """The shard after ``rank`` (in rank order, cyclically) that has
        not returned; the caller holds _turn_lock."""
        for k in range(1, self.size + 1):
            r = (rank + k) % self.size
            if self._active[r]:
                return r
        return None

    def _wait_turn(self, rank: int, gen: int) -> None:
        """Wait until ``rank`` holds the turn past barrier ``gen``; breaks
        the run after ``timeout`` seconds (a shard skipped a collective,
        or hung)."""
        deadline = time.monotonic() + self.timeout
        go = self._go[rank]
        while True:
            if not go.wait(max(deadline - time.monotonic(), 0.0)):
                self._break()
                raise threading.BrokenBarrierError
            go.clear()
            with self._turn_lock:
                if self._broken:
                    raise threading.BrokenBarrierError
                if self._gen > gen:
                    return
            # Handed the turn while the barrier still waits for a shard
            # that returned without reaching it: wait for the timeout.

    def _sync(self, rank: int) -> None:
        """The barrier: count ``rank`` in, hand the turn on, and wait for
        it to come back once every shard has arrived."""
        with self._turn_lock:
            if self._broken:
                raise threading.BrokenBarrierError
            gen = self._gen
            self._arrived += 1
            if self._arrived == self.size:
                self._arrived, self._gen = 0, gen + 1
            nxt = self._next_active(rank)
        self._go[nxt].set()
        self._wait_turn(rank, gen)

    def _finish(self, rank: int) -> None:
        """``rank`` returned: hand the turn to the next shard running."""
        with self._turn_lock:
            self._active[rank] = False
            nxt = self._next_active(rank)
        if nxt is not None:
            self._go[nxt].set()

    def _break(self) -> None:
        with self._turn_lock:
            self._broken = True
        for go in self._go:
            go.set()

    def _count(self, ctx: ShardContext, kind: str) -> None:
        # Rank 0 runs every collective of the mesh's program, so its count
        # is the mesh's; no other thread writes the table.
        if ctx.rank == 0:
            self.collectives[kind] = self.collectives.get(kind, 0) + 1


def _to(x, device):
    if isinstance(x, tuple):
        return tuple(_to(t, device) for t in x)
    return x if x.device == device else x.to(device)


def cuda_devices() -> list[torch.device]:
    """Every CUDA device; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass devices=[...] (e.g. "
            "['cpu'] * 8) to build a mesh on the host"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Sequence[int] | None = None,
              devices: Sequence | None = None) -> Mesh:
    """A (mdl, inst) mesh. ``devices=None`` means every CUDA device (and
    raises without one); a list may name one device more than once, one
    entry per shard (e.g. ``["cpu"] * 8``). ``shape=None`` puts every
    device on the model axis."""
    devices = list(cuda_devices() if devices is None else devices)
    if shape is None:
        shape = (len(devices), 1)
    return Mesh(devices, shape)


_axis_lock = threading.Lock()
_axis_meshes: dict[tuple, Mesh] = {}  #: guarded-by: _axis_lock


def axis_mesh(axis: str, devices: Sequence | None = None) -> Mesh:
    """The 1-D mesh on ``axis`` over ``devices`` (``None``: every CUDA
    device), one per axis and device list for the process: the models
    that run on it share its worker threads, and its collective counts
    are theirs."""
    devices = [torch.device(d) for d in
               (cuda_devices() if devices is None else devices)]
    key = (axis, tuple(str(d) for d in devices))
    with _axis_lock:
        mesh = _axis_meshes.get(key)
        if mesh is None:
            mesh = _axis_meshes[key] = Mesh(devices, (len(devices),),
                                            (axis,))
        return mesh


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


def _reduce(x: torch.Tensor, axis: str, op, kind: str) -> torch.Tensor:
    ctx = _ctx()
    ctx.mesh._count(ctx, kind)
    if ctx.mesh.shape[axis] == 1:
        return x
    parts = ctx.mesh._exchange(ctx, x, axis)
    out = parts[0]
    for p in parts[1:]:
        out = op(out, p)
    return out


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, added in axis order."""
    return _reduce(x, axis, torch.add, "psum")


def pmax(x: torch.Tensor, axis: str) -> torch.Tensor:
    return _reduce(x, axis, torch.maximum, "pmax")


def pmin(x: torch.Tensor, axis: str) -> torch.Tensor:
    return _reduce(x, axis, torch.minimum, "pmin")


def all_gather(x: torch.Tensor, axis: str, dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """The group's ``x`` in axis order, concatenated along ``dim``
    (``tiled``) or stacked on a new ``dim``."""
    ctx = _ctx()
    ctx.mesh._count(ctx, "all_gather")
    if ctx.mesh.shape[axis] == 1:
        return x if tiled else x.unsqueeze(dim)
    parts = ctx.mesh._exchange(ctx, x, axis)
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def all_to_all(x: torch.Tensor, axis: str, split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = False) -> torch.Tensor:
    """``jax.lax.all_to_all``: ``x`` is cut into n chunks along
    ``split_axis`` (n the size of ``axis``), chunk j goes to the group's
    j-th shard, and the chunks a shard receives are joined in axis order:
    shard i's output block j is shard j's input block i. ``tiled``: the
    chunks are n equal slices, joined along ``concat_axis``; otherwise
    ``split_axis`` must have size n, each chunk is one index of it (the
    axis drops), and the chunks stack on a new ``concat_axis``."""
    ctx = _ctx()
    ctx.mesh._count(ctx, "all_to_all")
    n = ctx.mesh.shape[axis]
    if tiled:
        if x.shape[split_axis] % n:
            raise ValueError(
                f"all_to_all: split axis of size {x.shape[split_axis]} "
                f"does not divide into {n} shards")
        step = x.shape[split_axis] // n

        def chunk(t, i):
            return t.narrow(split_axis, i * step, step)
    else:
        if x.shape[split_axis] != n:
            raise ValueError(
                f"all_to_all: split axis of size {x.shape[split_axis]} "
                f"for {n} shards")

        def chunk(t, i):
            return t.select(split_axis, i)
    me = ctx.coords[axis]
    if n == 1:
        parts = [chunk(x, 0)]
    else:
        parts = ctx.mesh._exchange(ctx, x, axis,
                                   take=lambda k, t: chunk(t, me))
    return torch.cat(parts, concat_axis) if tiled \
        else torch.stack(parts, concat_axis)


def ppermute(x: torch.Tensor, axis: str, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: ``perm`` holds ``(src, dst)`` pairs of
    indices on ``axis``; the shard at ``dst`` receives ``src``'s ``x``,
    and a shard that no pair names as a destination receives zeros."""
    ctx = _ctx()
    ctx.mesh._count(ctx, "ppermute")
    n = ctx.mesh.shape[axis]
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= i < n for i in srcs + dsts)):
        raise ValueError(f"ppermute: {perm} is not a permutation of "
                         f"{n} shards")
    src = dict(zip(dsts, srcs)).get(ctx.coords[axis])
    if n == 1:
        got = x if src is not None else None
    else:
        parts = ctx.mesh._exchange(
            ctx, x, axis, take=lambda k, t: t if k == src else None)
        got = None if src is None else parts[src]
    return torch.zeros_like(x) if got is None else got


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
        ctx.mesh._count(ctx, "combine")
        if ctx.mesh.shape[self.axis] == 1:
            return fn(*partials)
        groups = ctx.mesh._exchange(ctx, tuple(partials), self.axis)
        return fn(*(torch.cat(parts, 0) for parts in zip(*groups)))


# -- the serving mesh: a model's weights split over devices -------------------
#
# The solver meshes above shard the placement problem; the serving mesh
# splits model weights (models/server.py ``load_sharded``). A split leaf's
# column blocks live on the shards' devices, and the families' products
# run column-parallel from the calling thread (models/families.py
# ``_mm``): no shard thread runs, so a model on the serving mesh may also
# run ring attention or the expert-parallel FFN on their meshes.


class ShardedLeaf:
    """One parameter leaf on a serving mesh. Split (``spec`` names the
    mesh axis on the last dimension): ``blocks[r]`` is shard r's block of
    the columns, on its device, in storage of its own. Replicated
    (``spec == ()``): ``blocks[r]`` is the copy on shard r's device, one
    copy per distinct device. ``shape``, ``dtype``, ``numel`` and
    ``element_size`` are the whole leaf's; ``device`` is the first
    shard's."""

    def __init__(self, blocks: list, shape, dtype, spec: tuple,
                 devices: list):
        self.blocks = blocks
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.spec = spec
        self.devices = devices

    def __repr__(self) -> str:
        return (f"ShardedLeaf({tuple(self.shape)}, {self.dtype}, "
                f"spec={self.spec}, shards={len(self.blocks)})")

    @property
    def split(self) -> bool:
        return bool(self.spec)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def shard_nbytes(self, rank: int) -> int:
        """The bytes shard ``rank`` holds of this leaf."""
        b = self.blocks[rank]
        return b.numel() * b.element_size()

    def on(self, device) -> torch.Tensor:
        """The whole leaf on ``device``: a replicated leaf's copy there
        (or one copied there), a split leaf's blocks gathered in order."""
        device = torch.device(device)
        if not self.split:
            for b in self.blocks:
                if b.device == device:
                    return b
            return self.blocks[0].to(device)
        return torch.cat([b.to(device) for b in self.blocks], -1)


def local(leaf, device) -> torch.Tensor:
    """``leaf`` whole on ``device``: a tensor as it is, a ``ShardedLeaf``
    copied or gathered there for this use."""
    return leaf.on(device) if isinstance(leaf, ShardedLeaf) else leaf


def serving_mesh(n_devices: int | None = None,
                 devices: Sequence | None = None) -> Mesh:
    """The 1-D weight-splitting mesh (axis ``mdl``) over the first
    ``n_devices`` of ``devices`` (``None``: every CUDA device, raising
    without one). ``n_devices=None`` reads MM_SHARDED_MESH_DEVICES; 0
    means every device. Cached per device list, as the reference caches
    per size."""
    from modelmesh_tpu_torch.utils import envs

    if n_devices is None:
        n_devices = envs.get_int("MM_SHARDED_MESH_DEVICES")
    devs = list(cuda_devices() if devices is None else devices)
    n = len(devs) if not n_devices else min(int(n_devices), len(devs))
    return axis_mesh(MODEL_AXIS, devs[:max(n, 1)])


def param_pspec(leaf, n_devices: int) -> tuple:
    """How ONE parameter leaf lies on a serving mesh of ``n_devices``, as
    the reference's partition spec: its last axis split on ``mdl``
    (column-parallel, ``(None, ..., "mdl")``) when the leaf has two or
    more dimensions and the mesh divides that axis; replicated (``()``)
    otherwise. A non-dividing axis is replicated, never padded."""
    shape = tuple(getattr(leaf, "shape", ()))
    if len(shape) >= 2 and n_devices > 1 and shape[-1] % n_devices == 0:
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    return ()


def _shard_leaf(leaf, mesh: Mesh) -> ShardedLeaf:
    """``leaf`` (a tensor or array) on ``mesh`` by ``param_pspec``."""
    t = torch.as_tensor(leaf)
    spec = param_pspec(t, mesh.size)
    if spec:
        step = t.shape[-1] // mesh.size
        blocks = [t.narrow(-1, r * step, step).to(
            dev, copy=True, memory_format=torch.contiguous_format)
            for r, dev in enumerate(mesh.devices)]
    else:
        copies: dict = {}
        blocks = [copies.setdefault(str(dev), t.to(dev))
                  for dev in mesh.devices]
    return ShardedLeaf(blocks, t.shape, t.dtype, spec, list(mesh.devices))


def shard_params(params, mesh: Mesh):
    """A parameter tree (dicts and lists) with every leaf a
    ``ShardedLeaf`` on ``mesh``: block r of each split leaf on shard r's
    device, a copy of each replicated leaf on every device. Each device
    then holds 1/n of the split leaves."""
    if isinstance(params, dict):
        return {k: shard_params(v, mesh) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [shard_params(v, mesh) for v in params]
    return _shard_leaf(params, mesh)


def shard_nbytes(params, rank: int) -> int:
    """The bytes shard ``rank`` holds of a tree from ``shard_params``."""
    if isinstance(params, dict):
        return sum(shard_nbytes(v, rank) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(shard_nbytes(v, rank) for v in params)
    return params.shard_nbytes(rank)
