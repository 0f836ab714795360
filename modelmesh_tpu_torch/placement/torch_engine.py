"""Global placement: host snapshot -> device solve -> plan, and the
strategy that serves plans.

Port of ``modelmesh_tpu/placement/jax_engine.py``: ``snapshot_columns``
builds a columnar host snapshot of cluster state and ``patch_columns``
patches it for the records marked dirty (the delta snapshot);
``dispatch_solve`` expands it into a ``PlacementProblem`` on the device
and runs the solve (sparse top-K or the dense tier, by the reference's
dispatch rule; or, given the last full solve's ``SolveBase`` and dirty
row ids, the incremental dirty-row re-solve); ``finalize_plan`` reads the
result back in one batched readback and packs it into a ``GlobalPlan``.
``TorchPlacementStrategy`` routes each refresh between those paths and
answers placement decisions from the plan, with a fallback strategy
behind it. Plans are advisory: the serving layer's local guards stay
authoritative.

With a ``parallel.mesh`` mesh, ``dispatch_solve`` builds each shard's
block of the padded problem on its own device and runs the sharded solve
(``parallel/sharded_solver.py``); the strategy then keeps the incremental
path off, as the reference does.

Differences from the reference: the solve's convergence gates run on the
host, so ``dispatch_solve`` returns after the solve's last gate decision
(only the tail of the solve is still in flight; the incremental path has
no gates). The dispatch enqueues, behind the solve, the plan's
hottest-first order and its compaction and then the result's copy to
pinned host memory, and ``finalize_plan`` waits on that copy's event, so
it does not wait for a solve dispatched after it (the pipelined refresher,
``placement/refresh_loop.py``). Every host sync on the path is counted
(``device.host_syncs``) and reported per solve in
``plan.stats["host_syncs"]``. Buffer donation has no PyTorch port and
raises; the device ``carry`` is accepted.

Each refresh keeps a span record (``observability.tracing.RefreshSpans``):
spans ``mm.refresh.snapshot``, ``.rpm``, ``.dispatch``, ``.cost``,
``.select`` (sparse tier), ``.transport``, ``.auction``, ``.gate``,
``.readback_wait`` and ``.extract``, as ``record_function`` ranges while a
``torch.profiler`` records, and the device time of each solve layer, which
``finalize_plan`` writes into ``plan.stats``.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import threading
import time
from collections.abc import Mapping
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.observability import tracing
from modelmesh_tpu_torch.ops.costs import PlacementProblem
from modelmesh_tpu_torch.ops.sinkhorn import resolve_lse_impl
from modelmesh_tpu_torch.ops.solve import (
    SolveConfig,
    SolveInit,
    solve_placement,
    solve_placement_incremental,
)
from modelmesh_tpu_torch.ops.sparse import resolve_sparse_impl
from modelmesh_tpu_torch.parallel import mesh as mesh_mod
from modelmesh_tpu_torch.parallel.sharded_solver import make_sharded_solver
from modelmesh_tpu_torch.placement.greedy import GreedyStrategy
from modelmesh_tpu_torch.placement.strategy import (
    LOAD_HERE,
    ClusterView,
    PlacementRequest,
    PlacementStrategy,
)
from modelmesh_tpu_torch.records import InstanceRecord, ModelRecord, now_ms
from modelmesh_tpu_torch.utils import envs

log = logging.getLogger(__name__)

RpmSource = Union[Callable[[str], int], Mapping[str, int]]


class IdList(list):
    """A snapshot's model ids: a list that also holds them as an object
    array, built once with the snapshot (delta patches reuse it), so
    ``finalize_plan`` reorders the ids with one fancy index instead of a
    Python loop a refresh. Never mutated after it is built."""

    __slots__ = ("array",)

    def __init__(self, ids=()):
        super().__init__(ids)
        self.array = np.array(self, dtype=object)


def _id_array(ids: list) -> np.ndarray:
    """object[N] of ``ids``: the snapshot's own array when it has one."""
    arr = getattr(ids, "array", None)
    return arr if arr is not None else np.array(ids, dtype=object)


class ProblemColumns(NamedTuple):
    """Columnar host snapshot of cluster state — O(N + M + nnz + T·M)
    bytes. ``loaded`` is COO index pairs and the type-constraint masks are
    one [T, M] row pattern per model type plus a [N] type index; the dense
    [N, M] matrices are expanded on the device."""

    model_ids: list
    instance_ids: list
    sizes: np.ndarray       # f32[N]
    copies: np.ndarray      # i32[N]
    rates: np.ndarray       # f32[N]
    loaded_rows: np.ndarray  # i32[nnz] COO of the loaded matrix
    loaded_cols: np.ndarray  # i32[nnz]
    type_idx: np.ndarray    # i32[N] model -> type row in the masks
    req_masks: np.ndarray   # bool[T, M] hard type-constraint rows
    pref_masks: np.ndarray  # bool[T, M] soft preference rows
    capacity: np.ndarray    # f32[M]
    reserved: np.ndarray    # f32[M]
    lru_age: np.ndarray     # f32[M]
    busy: np.ndarray        # f32[M]
    zone: np.ndarray        # i32[M]
    placeable: np.ndarray   # bool[M] not shutting down / not disabled


class SnapshotCache:
    """What ``patch_columns`` needs to patch the last snapshot instead of
    rebuilding it: the raw per-record inputs the derived columns came
    from (last_used, used, lru_ts; rpm is re-read on every patch) and the
    id -> position maps, so a steady refresh touches only the dirty
    records. ``patch_columns`` copies an array before changing it, so
    columns handed out by earlier snapshots stay frozen."""

    __slots__ = (
        "cols", "last_used", "used", "lru_ts", "model_pos",
        "inst_pos", "zone_id", "tmap", "default_size_units", "max_copies",
        "constraints",
    )

    def __init__(self, cols, last_used, used, lru_ts, zone_id, tmap,
                 default_size_units, max_copies, constraints):
        self.cols = cols
        self.last_used = last_used
        self.used = used
        self.lru_ts = lru_ts
        self.model_pos = {mid: i for i, mid in enumerate(cols.model_ids)}
        self.inst_pos = {iid: j for j, iid in enumerate(cols.instance_ids)}
        self.zone_id = zone_id
        self.tmap = tmap
        self.constraints = constraints
        self.default_size_units = default_size_units
        self.max_copies = max_copies


def _rpm_column(rpm_fn: Optional[RpmSource], model_ids, n: int) -> np.ndarray:
    """Per-model rpm read (all zeros without a source): the refresh span
    ``rpm``."""
    with tracing.refresh_span("rpm"):
        if rpm_fn is None:
            return np.zeros(n, np.float32)
        lookup = rpm_fn.get if isinstance(rpm_fn, Mapping) else rpm_fn
        return np.fromiter((lookup(mid) or 0 for mid in model_ids),
                           np.float32, n)


def _derived_columns(rpm, last_used, sizes, loaded_rows, loaded_cols,
                     used, lru_ts, now, m: int):
    """Time/traffic-derived columns. Returns (rates, reserved, lru_age)."""
    # Recency proxy where the rate view reads 0.
    age_min = np.maximum(0.0, (now - last_used) / 60_000.0)
    rates = np.where(rpm > 0, rpm, 1000.0 / (1.0 + age_min)).astype(np.float32)
    # reserved = advertised usage not attributable to managed (loaded) mass.
    managed = np.bincount(
        loaded_cols, weights=sizes[loaded_rows], minlength=m
    ).astype(np.float32) if m else np.empty(0, np.float32)
    reserved = np.maximum(0.0, used - managed)
    lru_age = np.where(
        lru_ts > 0, np.maximum(0.0, (now - lru_ts) / 1000.0), 0.0
    ).astype(np.float32)
    return rates, reserved, lru_age


def snapshot_columns(
    models: Sequence[tuple[str, ModelRecord]],
    instances: Sequence[tuple[str, InstanceRecord]],
    rpm_fn: Optional[RpmSource] = None,
    default_size_units: int = 128,
    max_copies: int = 8,
    constraints=None,
    return_cache: bool = False,
):
    """Vectorized host snapshot: one C-speed pass per column.
    ``constraints`` (duck-typed ``is_candidate``/``is_preferred``) builds
    the per-type masks; without it every instance is a candidate. With
    ``return_cache`` the pair ``(cols, SnapshotCache)`` comes back, for
    later ``patch_columns`` calls."""
    model_ids = IdList(mid for mid, _ in models)
    instance_ids = [iid for iid, _ in instances]
    n, m = len(model_ids), len(instance_ids)
    inst_index = {iid: j for j, iid in enumerate(instance_ids)}
    zones = sorted({rec.zone for _, rec in instances})
    zone_id = {z: i for i, z in enumerate(zones)}
    now = now_ms()

    recs = [mr for _, mr in models]
    sizes = np.fromiter(
        (mr.size_units or default_size_units for mr in recs), np.float32, n
    )
    copies = np.clip(
        np.fromiter((mr.copy_count for mr in recs), np.int64, n),
        1, max_copies,
    ).astype(np.int32)
    last_used = np.fromiter((mr.last_used for mr in recs), np.int64, n)
    rpm = _rpm_column(rpm_fn, model_ids, n)

    pairs = [
        (i, inst_index[iid])
        for i, mr in enumerate(recs)
        for iid in mr.instance_ids
        if iid in inst_index
    ]
    loaded_rows = np.fromiter((p[0] for p in pairs), np.int32, len(pairs))
    loaded_cols = np.fromiter((p[1] for p in pairs), np.int32, len(pairs))

    tmap: dict[str, int] = {}
    type_idx = np.fromiter(
        (tmap.setdefault(mr.model_type, len(tmap)) for mr in recs),
        np.int32, n,
    )
    t = max(1, len(tmap))
    if constraints is not None and tmap:
        req_masks = np.empty((t, m), bool)
        pref_masks = np.empty((t, m), bool)
        for mtype, ti in tmap.items():
            for j, (_, rec) in enumerate(instances):
                req_masks[ti, j] = constraints.is_candidate(mtype, rec.labels)
                pref_masks[ti, j] = constraints.is_preferred(mtype, rec.labels)
    else:
        req_masks = np.ones((t, m), bool)
        pref_masks = np.ones((t, m), bool)

    irecs = [rec for _, rec in instances]
    capacity = np.maximum(
        np.fromiter((rec.capacity_units for rec in irecs), np.float32, m), 1.0
    )
    used = np.fromiter((rec.used_units for rec in irecs), np.float32, m)
    lru_ts = np.fromiter((rec.lru_ts for rec in irecs), np.int64, m)
    rates, reserved, lru_age = _derived_columns(
        rpm, last_used, sizes, loaded_rows, loaded_cols, used, lru_ts, now, m
    )
    busy = np.fromiter((rec.req_per_minute for rec in irecs), np.float32, m)
    zone = np.fromiter((zone_id[rec.zone] for rec in irecs), np.int32, m)
    placeable = np.fromiter(
        (not rec.shutting_down and not rec.disabled for rec in irecs), bool, m
    )
    cols = ProblemColumns(
        model_ids, instance_ids, sizes, copies, rates, loaded_rows,
        loaded_cols, type_idx, req_masks, pref_masks, capacity, reserved,
        lru_age, busy, zone, placeable,
    )
    if not return_cache:
        return cols
    return cols, SnapshotCache(
        cols, last_used, used, lru_ts, zone_id, tmap,
        default_size_units, max_copies, constraints,
    )


# Consecutive delta refreshes before the strategy forces a full rebuild:
# bounds how long the frozen noise epoch can pin an unlucky draw, and how
# long an unmarked change can stay stale, under perpetual small churn.
MAX_DELTA_STREAK = 64

# Above this dirty fraction a patch stops paying: the per-record work
# approaches the full rebuild's.
MAX_DIRTY_FRAC = 0.25


def patch_columns(
    cache: SnapshotCache,
    models: Sequence[tuple[str, ModelRecord]],
    instances: Sequence[tuple[str, InstanceRecord]],
    rpm_fn: Optional[RpmSource] = None,
    dirty_models: Optional[set] = None,
    dirty_instances: Optional[set] = None,
    constraints=None,
    max_dirty_frac: float = MAX_DIRTY_FRAC,
):
    """Delta snapshot: patch the cached ``ProblemColumns`` for the dirty
    records only. Returns the new columns (and updates ``cache`` in
    place), or ``None`` when the caller must rebuild with
    ``snapshot_columns``:

    - the model or instance list changed length;
    - a dirty id is unknown or no longer at its cached position;
    - a dirty record brings a new model type or zone;
    - ``constraints`` is not the object the snapshot was built under;
    - the dirty fraction exceeds ``max_dirty_frac``.

    Callers mark every changed record dirty; an unmarked change stays
    stale until the next rebuild. Columns that move without a record
    change are recomputed for every record on each patch: rpm re-read
    from ``rpm_fn``, and the time-derived rates, reserved and lru_age."""
    cols = cache.cols
    n, m = len(cols.model_ids), len(cols.instance_ids)
    if len(models) != n or len(instances) != m:
        return None
    if constraints is not cache.constraints:
        return None
    dm = dirty_models or set()
    di = dirty_instances or set()
    if (len(dm) + len(di)) > max_dirty_frac * (n + m):
        return None
    now = now_ms()

    sizes, copies, type_idx = cols.sizes, cols.copies, cols.type_idx
    last_used = cache.last_used
    rpm = _rpm_column(rpm_fn, cols.model_ids, n)
    loaded_rows, loaded_cols = cols.loaded_rows, cols.loaded_cols
    if dm:
        rows_i = []
        for mid in dm:
            i = cache.model_pos.get(mid)
            if i is None or models[i][0] != mid:
                return None
            if models[i][1].model_type not in cache.tmap:
                return None
            rows_i.append(i)
        sizes, copies, type_idx = (
            np.array(sizes), np.array(copies), np.array(type_idx)
        )
        last_used = np.array(last_used)
        for i in rows_i:
            mr = models[i][1]
            sizes[i] = mr.size_units or cache.default_size_units
            copies[i] = min(max(mr.copy_count, 1), cache.max_copies)
            last_used[i] = mr.last_used
            type_idx[i] = cache.tmap[mr.model_type]
        # COO patch: drop the dirty rows' pairs, append their fresh ones.
        keep = ~np.isin(loaded_rows, np.asarray(rows_i, np.int32))
        new_pairs = [
            (i, cache.inst_pos[iid])
            for i in rows_i
            for iid in models[i][1].instance_ids
            if iid in cache.inst_pos
        ]
        loaded_rows = np.concatenate([
            loaded_rows[keep],
            np.fromiter((p[0] for p in new_pairs), np.int32, len(new_pairs)),
        ])
        loaded_cols = np.concatenate([
            loaded_cols[keep],
            np.fromiter((p[1] for p in new_pairs), np.int32, len(new_pairs)),
        ])

    capacity, busy, zone, placeable = (
        cols.capacity, cols.busy, cols.zone, cols.placeable
    )
    used, lru_ts = cache.used, cache.lru_ts
    req_masks, pref_masks = cols.req_masks, cols.pref_masks
    if di:
        cols_j = []
        for iid in di:
            j = cache.inst_pos.get(iid)
            if j is None or instances[j][0] != iid:
                return None
            if instances[j][1].zone not in cache.zone_id:
                return None
            cols_j.append(j)
        capacity, busy, zone, placeable = (
            np.array(capacity), np.array(busy), np.array(zone),
            np.array(placeable),
        )
        used, lru_ts = np.array(used), np.array(lru_ts)
        patch_masks = constraints is not None and cache.tmap
        if patch_masks:
            req_masks = np.array(req_masks)
            pref_masks = np.array(pref_masks)
        for j in cols_j:
            rec = instances[j][1]
            capacity[j] = max(rec.capacity_units, 1.0)
            used[j] = rec.used_units
            lru_ts[j] = rec.lru_ts
            busy[j] = rec.req_per_minute
            zone[j] = cache.zone_id[rec.zone]
            placeable[j] = not rec.shutting_down and not rec.disabled
            if patch_masks:
                for mtype, ti in cache.tmap.items():
                    req_masks[ti, j] = constraints.is_candidate(
                        mtype, rec.labels
                    )
                    pref_masks[ti, j] = constraints.is_preferred(
                        mtype, rec.labels
                    )

    rates, reserved, lru_age = _derived_columns(
        rpm, last_used, sizes, loaded_rows, loaded_cols, used, lru_ts, now, m
    )
    new_cols = ProblemColumns(
        cols.model_ids, cols.instance_ids, sizes, copies, rates,
        loaded_rows, loaded_cols, type_idx, req_masks, pref_masks,
        capacity, reserved, lru_age, busy, zone, placeable,
    )
    cache.cols = new_cols
    cache.last_used = last_used
    cache.used, cache.lru_ts = used, lru_ts
    return new_cols


def _bucket(x: int, floor: int = 256) -> int:
    """Next padded size: powers of two plus three-quarter points (<= 33%
    overhead), so drifting fleet sizes reuse a few problem shapes."""
    if x <= floor:
        return floor
    p = 1 << (x - 1).bit_length()  # next power of two >= x
    three_q = (p // 4) * 3
    return three_q if x <= three_q else p


def _padded_host(cols: ProblemColumns) -> dict:
    """The bucket-padded host arrays ``_assemble`` takes. Padded rows are
    inert (sizes=0, copies=0), padded columns too (placeable=False ->
    infeasible, free capacity 0); rates/busy/lru_age pad with their real
    minimum so the min-max norms of the real entries do not move. The
    COO pairs index real rows and columns only, so they need no padding."""
    n, m = len(cols.model_ids), len(cols.instance_ids)
    n_p, m_p = _bucket(n), _bucket(m, 64)

    def padv(a, size, fill):
        if size == len(a):
            return a
        out = np.full(size, fill, a.dtype)
        out[: len(a)] = a
        return out

    min_or = lambda a, d: float(a.min()) if len(a) else d  # noqa: E731
    req_masks, pref_masks = cols.req_masks, cols.pref_masks
    if m_p != m:
        req_masks = np.pad(req_masks, ((0, 0), (0, m_p - m)))
        pref_masks = np.pad(pref_masks, ((0, 0), (0, m_p - m)))
    host = dict(
        sizes=padv(cols.sizes, n_p, 0.0),
        copies=padv(cols.copies, n_p, 0),
        rates=padv(cols.rates, n_p, min_or(cols.rates, 0.0)),
        type_idx=padv(cols.type_idx, n_p, 0),
        rows=cols.loaded_rows,
        ccols=cols.loaded_cols,
        req_masks=req_masks,
        pref_masks=pref_masks,
        capacity=padv(cols.capacity, m_p, 1.0),
        reserved=padv(cols.reserved, m_p, 1.0),
        lru_age=padv(cols.lru_age, m_p, min_or(cols.lru_age, 0.0)),
        busy=padv(cols.busy, m_p, min_or(cols.busy, 0.0)),
        zone=padv(cols.zone, m_p, 0),
        placeable=padv(cols.placeable, m_p, False),
    )
    return host


def _to_device(host: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}


def _expand_problem_device(cols: ProblemColumns, device) -> PlacementProblem:
    """Build the bucket-padded PlacementProblem on ``device``
    (``_padded_host``)."""
    return _assemble(**_to_device(_padded_host(cols), device))


# The axis each of ``_padded_host``'s per-model and per-instance arrays is
# split on (the type masks are [T, M]: their columns split on inst).
_HOST_AXES = {
    "sizes": mesh_mod.MODEL_AXIS, "copies": mesh_mod.MODEL_AXIS,
    "rates": mesh_mod.MODEL_AXIS, "type_idx": mesh_mod.MODEL_AXIS,
    "capacity": mesh_mod.INSTANCE_AXIS, "reserved": mesh_mod.INSTANCE_AXIS,
    "lru_age": mesh_mod.INSTANCE_AXIS, "busy": mesh_mod.INSTANCE_AXIS,
    "zone": mesh_mod.INSTANCE_AXIS, "placeable": mesh_mod.INSTANCE_AXIS,
}


def _expand_problem_blocks(cols: ProblemColumns, mesh) -> list:
    """Each shard's block of the bucket-padded problem, built on the
    shard's device from its slice of the host columns and the COO pairs
    that fall in it: no device holds the full [N, M] masks. Blocks in
    rank order (what ``sharded_solver.shard_problem`` gives for the
    padded problem)."""
    host = _padded_host(cols)
    n_pad, m_pad = len(host["sizes"]), len(host["capacity"])
    rows, ccols = host["rows"], host["ccols"]
    blocks = []
    for rank in range(mesh.size):
        r0, r1 = mesh.block_range(rank, mesh_mod.MODEL_AXIS, n_pad)
        c0, c1 = mesh.block_range(rank, mesh_mod.INSTANCE_AXIS, m_pad)
        lo = {mesh_mod.MODEL_AXIS: r0, mesh_mod.INSTANCE_AXIS: c0}
        hi = {mesh_mod.MODEL_AXIS: r1, mesh_mod.INSTANCE_AXIS: c1}
        block = {k: host[k][lo[ax]:hi[ax]] for k, ax in _HOST_AXES.items()}
        inside = (rows >= r0) & (rows < r1) & (ccols >= c0) & (ccols < c1)
        block["rows"] = rows[inside] - r0
        block["ccols"] = ccols[inside] - c0
        block["req_masks"] = host["req_masks"][:, c0:c1]
        block["pref_masks"] = host["pref_masks"][:, c0:c1]
        blocks.append(_assemble(**_to_device(block, mesh.devices[rank])))
    return blocks


def _assemble(sizes, copies, rates, rows, ccols, type_idx, req_masks,
              pref_masks, capacity, reserved, lru_age, busy, zone,
              placeable) -> PlacementProblem:
    """Device-side expansion of the COO loaded pairs and the per-type masks
    into the dense [N, M] matrices."""
    n, m = sizes.shape[0], capacity.shape[0]
    loaded = torch.zeros((n, m), dtype=torch.bool, device=sizes.device)
    # The reference pads the COO to a bucket with out-of-range rows that its
    # scatter drops (mode="drop"); index_put_ has no drop mode, so the COO
    # is not padded here and every pair is in range. (Filtering on the
    # device instead would be a hidden host sync: a boolean index must
    # read its count back.)
    loaded.index_put_(
        (rows.long(), ccols.long()),
        torch.ones((), dtype=torch.bool, device=sizes.device),
    )
    type_ix = type_idx.long()
    feasible = req_masks[type_ix] & placeable[None, :]
    preferred = pref_masks[type_ix]
    return PlacementProblem(
        sizes=sizes, copies=copies, rates=rates, loaded=loaded,
        feasible=feasible, capacity=capacity, reserved=reserved,
        lru_age=lru_age, busyness=busy, zone=zone, preferred=preferred,
    )


# Sparse-dispatch policy: default candidate width, and the auto rule's
# floor on padded instances (the up-front full-width gather only pays when
# the fleet is several times the candidate width).
SPARSE_TOPK_DEFAULT = 24
SPARSE_AUTO_MIN_INSTANCES = 192


def _resolve_sparse_config(config, m_pad: int, max_copies: int):
    """Pick dense vs sparse for this dispatch and finalize the config —
    the reference's rule, unchanged. Returns ``(config, sparse)``.

    An explicit ``config.topk`` or MM_SOLVER_SPARSE=1 forces sparse,
    MM_SOLVER_SPARSE=0 forces dense, and "auto" goes sparse when the
    padded instance count clears SPARSE_AUTO_MIN_INSTANCES and 4x the
    candidate width. A sparse dispatch narrows ``sel_width`` to the real
    max copy count (bucketed to 2/4/8) and, unless
    ``tier_defaults=False``, swaps knobs left at their dense defaults
    for the sparse-tier ones (auction_iters=8, auction_stall_tol=1e-3,
    sinkhorn_tol=0.02)."""

    def _densified(c):
        if c is not None and c.topk > 0:
            return c._replace(topk=0)
        return c

    cfg = SolveConfig() if config is None else config
    pin = (envs.get("MM_SOLVER_SPARSE") or "auto").strip().lower()
    if pin in ("0", "false", "no", "off"):
        return _densified(config), False
    topk = cfg.topk
    if topk <= 0:
        raw = envs.get("MM_SOLVER_TOPK")
        topk = int(raw) if raw not in (None, "") else SPARSE_TOPK_DEFAULT
    forced = pin in ("1", "true", "yes", "on") or cfg.topk > 0
    auto_ok = m_pad >= SPARSE_AUTO_MIN_INSTANCES and m_pad >= 4 * topk
    if not (forced or auto_ok) or topk >= m_pad:
        return _densified(config), False
    if cfg.tau > 0 and cfg.noise_impl != "hash":
        return _densified(config), False
    if cfg.sel_width <= 0:
        sel = 2 if max_copies <= 2 else (4 if max_copies <= 4 else 8)
        cfg = cfg._replace(sel_width=sel)
    overrides = {"topk": topk}
    if cfg.tier_defaults:
        if cfg.auction_iters == 40 and not envs.get("MM_SOLVER_AUCTION_ITERS"):
            overrides["auction_iters"] = 8
        if cfg.auction_stall_tol == 0.0 and not envs.get(
            "MM_SOLVER_AUCTION_STALL_TOL"
        ):
            overrides["auction_stall_tol"] = 1e-3
        if cfg.sinkhorn_tol == 0.0 and not envs.get("MM_SOLVER_SINKHORN_TOL"):
            overrides["sinkhorn_tol"] = 0.02
    return cfg._replace(**overrides), True


# Quality gate of the incremental path: a merged re-solve whose overflow
# drifts more than this fraction of demand past the base full solve's own
# overflow falls back to a full solve.
INCREMENTAL_OVERFLOW_FRAC = 0.005

# Traffic drift that re-selects a CLEAN row on the incremental path: a row
# whose rate moved by more than this fraction of the base solve's hottest
# rate joins the dirty set.
RATE_DRIFT_FRAC = 0.2


class SolveBase(NamedTuple):
    """Frozen state of the last full solve: the incremental path's merge
    target (device tensors at the padded shapes, on the solve's device).
    ``seed`` is the noise epoch it was solved under: the carried prices,
    potentials and the draw are a matched triple."""

    indices: torch.Tensor   # i64[n_pad, MAX_COPIES]
    valid: torch.Tensor     # bool[n_pad, MAX_COPIES]
    g: torch.Tensor         # f32[m_pad] frozen column potentials
    prices: torch.Tensor    # f32[m_pad] frozen congestion prices
    row_err: torch.Tensor   # f32[] frozen Sinkhorn diagnostic
    seed: int
    # The full solve's overflow (host float): the quality gate bounds the
    # drift past it. Not advanced by increments.
    overflow: float = 0.0
    # f32[n] host copy of the rates the full solve ranked under, for the
    # rate-drift re-selection; frozen like the overflow.
    rates: Optional[np.ndarray] = None


def solve_config_from_env() -> SolveConfig:
    """SolveConfig overridden by the MM_SOLVER_* operator knobs."""
    base = SolveConfig()
    overrides = {}
    for field, env, cast in (
        ("sinkhorn_iters", "MM_SOLVER_SINKHORN_ITERS", int),
        ("auction_iters", "MM_SOLVER_AUCTION_ITERS", int),
        ("tau", "MM_SOLVER_TAU", float),
        ("lse_impl", "MM_SOLVER_LSE_IMPL", str),
        ("load_impl", "MM_SOLVER_LOAD_IMPL", str),
        ("noise_impl", "MM_SOLVER_NOISE_IMPL", str),
        ("final_select", "MM_SOLVER_FINAL_SELECT", str),
        ("sinkhorn_tol", "MM_SOLVER_SINKHORN_TOL", float),
        ("sinkhorn_chunk", "MM_SOLVER_SINKHORN_CHUNK", int),
        ("auction_stall_tol", "MM_SOLVER_AUCTION_STALL_TOL", float),
        ("sparse_impl", "MM_SOLVER_SPARSE_IMPL", str),
    ):
        raw = envs.get(env)
        if raw not in (None, ""):
            overrides[field] = cast(raw)
    return base._replace(**overrides) if overrides else base


class GlobalPlan:
    """Solved assignment: model -> ordered preferred instances.

    Held columnar (model ids, per-model target counts, flat instance
    indices, instance ids); the per-model dict is built only when someone
    reads ``placements``. ``to_bytes``/``from_bytes`` speak the
    reference's v2 wire format (zlib'd header + id tables + u8 counts +
    u16/u32 indices), so plans travel between the two packages."""

    _MAGIC_V2 = b"MMP2"

    def __init__(
        self, placements: Optional[dict[str, list[str]]], solved_at_ms: int,
        solve_ms: float, generation: int = 0,
    ):
        self._placements = placements
        self._columnar: Optional[tuple[list, np.ndarray, np.ndarray, list]] = None
        self._index: Optional[dict[str, int]] = None
        self._offsets: Optional[np.ndarray] = None
        self.solved_at_ms = solved_at_ms
        self.solve_ms = solve_ms
        self.generation = generation
        self.adopted_at_ms = solved_at_ms
        # Local-only stage timings and solve diagnostics (not serialized).
        self.stats: dict[str, object] = {}
        # Per-instance column potentials / prices for warm-starting the
        # next solve (local-only).
        self.warm_g: Optional[dict[str, float]] = None
        self.warm_price: Optional[dict[str, float]] = None

    @classmethod
    def from_columnar(
        cls, model_ids: list, counts: np.ndarray, flat: np.ndarray,
        inst_ids: list, solved_at_ms: int, solve_ms: float,
        generation: int = 0,
    ) -> "GlobalPlan":
        """``counts[i]`` targets of ``model_ids[i]`` live at
        ``flat[offsets[i]:offsets[i]+counts[i]]`` (indices into inst_ids)."""
        counts = np.asarray(counts)
        if counts.size and int(counts.max()) > 255:
            raise ValueError("per-model target count exceeds 255")
        plan = cls(None, solved_at_ms, solve_ms, generation)
        plan._columnar = (model_ids, counts.astype(np.uint8),
                          np.asarray(flat), inst_ids)
        return plan

    @property
    def placements(self) -> dict[str, list[str]]:
        if self._placements is None:
            model_ids, counts, flat, inst_ids = self._columnar
            flat_list = flat.tolist()
            placements: dict[str, list[str]] = {}
            pos = 0
            for mid, c in zip(model_ids, counts.tolist()):
                placements[mid] = [inst_ids[j] for j in flat_list[pos:pos + c]]
                pos += c
            self._placements = placements
        return self._placements

    def num_models(self) -> int:
        if self._placements is not None:
            return len(self._placements)
        return len(self._columnar[0])

    def ensure_index(self) -> None:
        """Build the lookup index now (the plan follower does, in its
        watch thread, so the first routed request does not pay for it)."""
        if self._columnar is not None and self._index is None:
            model_ids, counts, _, _ = self._columnar
            off = np.zeros(len(model_ids) + 1, np.int64)
            np.cumsum(counts, out=off[1:])
            # _offsets before _index: a reader treats a set _index as ready.
            self._offsets = off
            self._index = {mid: i for i, mid in enumerate(model_ids)}

    def lookup(self, model_id: str) -> Optional[list[str]]:
        """Targets for one model (no full dict needed)."""
        if self._placements is not None:
            return self._placements.get(model_id)
        self.ensure_index()
        row = self._index.get(model_id)
        if row is None:
            return None
        _, counts, flat, inst_ids = self._columnar
        start = int(self._offsets[row])
        end = start + int(counts[row])
        return [inst_ids[j] for j in flat[start:end].tolist()]

    def truncate(self, keep: int) -> "GlobalPlan":
        """The first ``keep`` models (hottest first), for the publisher's
        byte-budget trim. The columnar form keeps only the instances the
        kept rows use, re-indexed, so the payload really shrinks."""
        if self._columnar is not None:
            model_ids, counts, flat, inst_ids = self._columnar
            cut = int(np.sum(counts[:keep], dtype=np.int64))
            flat_cut = flat[:cut]
            used = np.unique(flat_cut)
            plan = GlobalPlan.from_columnar(
                model_ids[:keep], counts[:keep],
                np.searchsorted(used, flat_cut),
                [inst_ids[int(j)] for j in used],
                self.solved_at_ms, self.solve_ms, self.generation,
            )
        else:
            items = list(self._placements.items())[:keep]
            plan = GlobalPlan(
                dict(items), self.solved_at_ms, self.solve_ms, self.generation
            )
        plan.adopted_at_ms = self.adopted_at_ms
        return plan

    def age_ms(self) -> int:
        """Milliseconds since this plan was adopted locally (plans expire
        on local clocks)."""
        return now_ms() - self.adopted_at_ms

    def to_bytes(self) -> bytes:
        import json
        import zlib

        if self._columnar is not None and self._placements is None:
            model_ids, counts, flat, inst_ids = self._columnar
            if not any("\n" in s for s in model_ids) and not any(
                "\n" in s for s in inst_ids
            ):
                idx_dtype = np.uint16 if len(inst_ids) < 65_536 else np.uint32
                return self._pack_v2(
                    inst_ids, model_ids, counts,
                    np.asarray(flat, idx_dtype), idx_dtype,
                )
        # Ids with newlines or rows with >255 targets fall back to JSON.
        if any(
            len(kv[1]) > 255 or "\n" in kv[0] or any("\n" in t for t in kv[1])
            for kv in self.placements.items()
        ):
            payload = json.dumps({
                "g": self.generation, "t": self.solved_at_ms,
                "ms": self.solve_ms, "p": self.placements,
            }, separators=(",", ":"))
            return zlib.compress(payload.encode(), level=1)
        inst_table: dict[str, int] = {}
        counts = np.empty(len(self.placements), np.uint8)
        flat: list[int] = []
        for i, targets in enumerate(self.placements.values()):
            counts[i] = len(targets)
            for t in targets:
                flat.append(inst_table.setdefault(t, len(inst_table)))
        idx_dtype = np.uint16 if len(inst_table) < 65_536 else np.uint32
        return self._pack_v2(
            list(inst_table), list(self.placements), counts,
            np.asarray(flat, idx_dtype), idx_dtype,
        )

    def _pack_v2(self, inst_ids, model_ids, counts, flat, idx_dtype) -> bytes:
        import json
        import zlib

        header = json.dumps({
            "g": self.generation, "t": self.solved_at_ms,
            "ms": self.solve_ms, "n": len(model_ids),
            "w": int(np.dtype(idx_dtype).itemsize),
        }, separators=(",", ":")).encode()

        def framed(b: bytes) -> list[bytes]:
            return [len(b).to_bytes(4, "big"), b]

        parts = [
            self._MAGIC_V2,
            *framed(header),
            *framed("\n".join(inst_ids).encode()),
            *framed("\n".join(model_ids).encode()),
            np.ascontiguousarray(counts, np.uint8).tobytes(),
            np.ascontiguousarray(flat, idx_dtype).tobytes(),
        ]
        return zlib.compress(b"".join(parts), level=1)

    @classmethod
    def from_bytes(cls, data: bytes) -> "GlobalPlan":
        import json
        import zlib

        raw = zlib.decompress(data)
        if not raw.startswith(cls._MAGIC_V2):
            d = json.loads(raw.decode())
            plan = cls(d["p"], d["t"], d["ms"], d.get("g", 0))
            plan.adopted_at_ms = now_ms()
            return plan
        off = len(cls._MAGIC_V2)

        def take(n):
            nonlocal off
            out = raw[off:off + n]
            off += n
            return out

        hlen = int.from_bytes(take(4), "big")
        h = json.loads(take(hlen).decode())
        inst_ids = take(int.from_bytes(take(4), "big")).decode().split("\n")
        model_blob = take(int.from_bytes(take(4), "big")).decode()
        model_ids = model_blob.split("\n") if model_blob else []
        n = h["n"]
        counts = np.frombuffer(take(n), np.uint8)
        idx_dtype = np.uint16 if h["w"] == 2 else np.uint32
        flat = np.frombuffer(raw[off:], idx_dtype)
        plan = cls.from_columnar(
            model_ids, counts, flat, inst_ids, h["t"], h["ms"], h.get("g", 0)
        )
        plan.adopted_at_ms = now_ms()
        return plan


class PendingSolve(NamedTuple):
    """A dispatched, not yet finalized solve (``sol`` holds device
    tensors; the tail of the solve may still be running). ``readback`` is
    its result's copy to the host, enqueued behind the solve at dispatch:
    finalizing waits for this solve only, not for one dispatched after
    it."""

    cols: ProblemColumns
    sol: object          # ops.solve.Placement
    t_start: float       # perf_counter at snapshot start
    t_snapshot: float    # perf_counter when the host snapshot was done
    warm: bool
    path: str = "sparse"
    topk: int = 0
    # The path's kernel knob and the backend that ran (cuda | plain):
    # "sparse_impl" on a sparse solve, "lse_impl" on a dense or an
    # incremental one (the row LSE).
    impl_knob: str = "sparse_impl"
    impl: str = "cuda"
    dispatch_syncs: int = 0     # host syncs the dispatch made
    dirty_rows: Optional[int] = None  # rows re-solved (incremental only)
    t_dispatched: Optional[float] = None  # perf_counter when dispatch returned
    # None: finalize_plan enqueues the readback itself.
    readback: Optional[device_mod.Readback] = None
    # The refresh's span record (None outside a refresh): finalize_plan
    # resolves it into plan.stats.
    spans: Optional[tracing.RefreshSpans] = None


def dispatch_solve(
    cols: ProblemColumns,
    seed: int = 0,
    mesh=None,
    warm_g: Optional[Mapping[str, float]] = None,
    warm_price: Optional[Mapping[str, float]] = None,
    config=None,
    carry=None,
    donate: bool = False,
    t_start: Optional[float] = None,
    t_snapshot: Optional[float] = None,
    base: Optional[SolveBase] = None,
    dirty_rows=None,
    *,
    device=None,
) -> PendingSolve:
    """Expand ``cols`` on ``device`` and run the solve: sparse top-K, or
    the dense tier for small fleets and the MM_SOLVER_SPARSE=0 pin
    (``_resolve_sparse_config``).

    With ``base`` (the last full solve's ``SolveBase``) and ``dirty_rows``
    (row ids into ``cols.model_ids``) it runs the incremental dirty-row
    re-solve instead: only those rows are re-selected against the frozen
    column state and merged into the base assignment
    (``solve_placement_incremental``). Callers gate on the dirty fraction
    and the noise epoch (``TorchPlacementStrategy``) and check the merged
    overflow after finalizing.

    With ``mesh`` (a ``parallel.mesh.Mesh``) the solve is sharded
    (``parallel/sharded_solver.py``): each shard's block of the padded
    problem is built on its own device from the host columns, the mesh
    must divide the padded problem (``ValueError`` otherwise), the joined
    result lands on the mesh's first device, and the path is
    "sharded-sparse" or "sharded". A mesh of another type raises
    ``NotImplementedError``, and so does ``donate`` (PyTorch has no buffer
    donation).

    ``device=None`` means the first CUDA device, and raises without one
    (``device.resolve_device``); with a mesh it means the mesh's first
    device, and another device raises. Warm starts, in order of
    preference: ``carry`` as (g0, price0) tensors already padded and
    column-aligned on the device; else the ``warm_g``/``warm_price``
    per-instance-id dicts of the previous plan (instances unknown to them
    start cold); else zeros."""
    if mesh is not None and not isinstance(mesh, mesh_mod.Mesh):
        raise NotImplementedError(
            f"mesh must be a modelmesh_tpu_torch.parallel.mesh.Mesh (got "
            f"{type(mesh).__name__})"
        )
    if donate:
        raise NotImplementedError("buffer donation has no PyTorch port")
    dev = _solve_device(mesh, device)
    syncs0, waited0 = device_mod.host_syncs, device_mod.host_sync_s
    t_start = time.perf_counter() if t_start is None else t_start
    t_snapshot = time.perf_counter() if t_snapshot is None else t_snapshot
    spans = tracing.current_refresh()
    if spans is not None:
        spans.begin_solve(dev if mesh is None else None)
    with tracing.record_span(spans, "dispatch"):
        sol, fields = _dispatch(cols, seed, mesh, warm_g, warm_price,
                                config, carry, base, dirty_rows, dev)
        readback = _enqueue_readback(sol, fields.pop("rates"),
                                     len(cols.model_ids))
        if spans is not None:
            spans.mark("done", readback.done)
            spans.gate_wait_ms = (device_mod.host_sync_s - waited0) * 1e3
    return PendingSolve(
        cols=cols, sol=sol, t_start=t_start, t_snapshot=t_snapshot,
        dispatch_syncs=device_mod.host_syncs - syncs0, readback=readback,
        t_dispatched=time.perf_counter(), spans=spans, **fields,
    )


def _dispatch(cols, seed, mesh, warm_g, warm_price, config, carry, base,
              dirty_rows, dev):
    """``dispatch_solve``'s expansion and solve: the solution and the
    ``PendingSolve`` fields that describe its path."""
    n_pad = _bucket(len(cols.model_ids))
    m_pad = _bucket(len(cols.instance_ids), 64)
    max_copies = int(cols.copies.max()) if len(cols.copies) else 1
    config, sparse = _resolve_sparse_config(config, m_pad, max_copies)
    cfg = SolveConfig() if config is None else config

    if base is not None and dirty_rows is not None:
        if mesh is not None:
            raise ValueError("incremental re-solve requires mesh=None")
        if base.indices.shape[0] != n_pad or base.g.shape[0] != m_pad:
            raise ValueError(
                "SolveBase shapes do not match the padded problem "
                "(stale base after a fleet resize?)"
            )
        impl = resolve_lse_impl(cfg.lse_impl, dev)
        with tracing.refresh_span("cost"):
            problem = _expand_problem_device(cols, dev)
        d = np.asarray(sorted(int(r) for r in dirty_rows), np.int64)
        padded = np.full(_bucket(max(len(d), 1), 64), n_pad, np.int64)
        padded[: len(d)] = d
        sol = solve_placement_incremental(
            problem, cfg, seed, torch.from_numpy(padded).to(dev),
            base.indices, base.valid, base.g, base.prices, base.row_err,
        )
        return sol, dict(warm=True, path="incremental", topk=cfg.topk,
                         impl_knob="lse_impl", impl=impl, dirty_rows=len(d),
                         rates=problem.rates)

    if sparse:
        impl_knob, impl = "sparse_impl", resolve_sparse_impl(
            cfg.sparse_impl, dev)
    else:
        impl_knob, impl = "lse_impl", resolve_lse_impl(cfg.lse_impl, dev)
    if carry is not None:
        g0_t, price0_t = carry
        if g0_t.shape[0] != m_pad or price0_t.shape[0] != m_pad:
            raise ValueError(
                f"device carry shape {g0_t.shape[0]} != padded columns "
                f"{m_pad}"
            )
        init = SolveInit(g0=g0_t.to(dev), price0=price0_t.to(dev))
        warm = True
    else:
        g0 = np.zeros(m_pad, np.float32)
        price0 = np.zeros(m_pad, np.float32)
        if warm_g:
            for j, iid in enumerate(cols.instance_ids):
                g0[j] = warm_g.get(iid, 0.0)
        if warm_price:
            for j, iid in enumerate(cols.instance_ids):
                price0[j] = warm_price.get(iid, 0.0)
        init = SolveInit(g0=torch.from_numpy(g0).to(dev),
                         price0=torch.from_numpy(price0).to(dev))
        warm = bool(warm_g)
    if mesh is not None:
        n_mdl = mesh.shape[mesh_mod.MODEL_AXIS]
        n_inst = mesh.shape[mesh_mod.INSTANCE_AXIS]
        if n_pad % n_mdl or m_pad % n_inst:
            raise ValueError(
                f"mesh {dict(mesh.shape)} does not divide the padded problem "
                f"[{n_pad}, {m_pad}]"
            )
        with tracing.refresh_span("cost"):
            blocks = _expand_problem_blocks(cols, mesh)
        sol = make_sharded_solver(mesh, cfg)(
            blocks, seed=seed, g0=init.g0, price0=init.price0,
        )
        # The rates are split across the shards: the plan's order takes
        # a copy of the host column on the first device.
        rates = device_mod.upload(cols.rates, dev)
        path = "sharded-sparse" if sparse else "sharded"
    else:
        with tracing.refresh_span("cost"):
            problem = _expand_problem_device(cols, dev)
        sol = solve_placement(problem, config=cfg, seed=seed, init=init)
        rates = problem.rates
        path = "sparse" if sparse else "dense"
    return sol, dict(warm=warm, path=path, topk=cfg.topk if sparse else 0,
                     impl_knob=impl_knob, impl=impl, rates=rates)


def _solve_device(mesh, device) -> torch.device:
    """The device a dispatch solves on (and its result lands on):
    ``device.resolve_device(device)``, or with a mesh the mesh's first
    device, which ``device`` must name when given."""
    if mesh is None:
        return device_mod.resolve_device(device)
    first = mesh.devices[0]
    if device is not None and torch.device(device) != first:
        raise ValueError(
            f"device {device} is not the mesh's first device {first}"
        )
    return first


def _hottest_first(rates: torch.Tensor) -> torch.Tensor:
    """i64[n]: ``np.argsort(-rates, kind="stable")``, on the rates'
    device. The key is -rates as an int32 that orders as the float does:
    ``0 - rates`` makes -0 and +0 one key, every NaN is one key past +inf
    (numpy sorts NaN last), and the stable sort keeps ties in row
    order."""
    neg = 0.0 - rates.to(torch.float32)
    bits = neg.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    key = key.masked_fill(torch.isnan(neg), torch.iinfo(torch.int32).max)
    return torch.sort(key, stable=True).indices


def _plan_parts(sol, rates: torch.Tensor, n: int) -> list:
    """The plan in publish order, as int32 tensors enqueued on the
    solve's device (no host sync: every shape is fixed by ``n``): each
    row's position in the hottest-first order [n] (the inverse of the
    order: the host scatters the ids by it, walking them in row order);
    the rows' valid counts in that order, as u8 padded to whole int32s
    [ceil(n / 4)]; and the rows' valid indices in that order, compacted
    to the front of an [n * width] block (``_unpack_plan``). ``valid`` is
    a prefix mask by construction, so a row's count is its first slots;
    the other slots scatter to a dump slot past the block."""
    width = sol.indices.shape[1]
    order = _hottest_first(rates[:n])
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=order.device))
    idx = sol.indices[:n].index_select(0, order).to(torch.int32)
    cnt = sol.valid[:n].sum(dim=1, dtype=torch.int32).index_select(0, order)
    start = torch.cumsum(cnt, 0) - cnt
    slot = torch.arange(width, device=idx.device)
    dest = torch.where(slot < cnt[:, None], start[:, None] + slot, n * width)
    flat = torch.zeros(n * width + 1, dtype=torch.int32, device=idx.device)
    flat.scatter_(0, dest.reshape(-1), idx.reshape(-1))
    counts = torch.nn.functional.pad(cnt.to(torch.uint8), (0, -n % 4))
    return [rank.to(torch.int32), counts.view(torch.int32), flat[:-1]]


def _unpack_plan(host: np.ndarray, n: int, width: int):
    """``_plan_parts`` from the readback's host buffer, as views: (rank
    i32[n], counts u8[n], the compacted block i32[n * width], the f32
    scalars and carries that follow it)."""
    nc = (n + 3) // 4
    end = n + nc + n * width
    return (host[:n], host[n:n + nc].view(np.uint8)[:n],
            host[n + nc:end], host[end:].view(np.float32))


def _enqueue_readback(sol, rates: torch.Tensor, n: int) -> device_mod.Readback:
    """The cycle's one readback, enqueued behind the solve: the plan in
    publish order (``_plan_parts``) followed by the f32 overflow, row_err
    and (when the solve has them) g and prices, carried in the same int32
    buffer bit for bit."""
    floats = [sol.overflow.reshape(1), sol.row_err.reshape(1)]
    if sol.g is not None and sol.prices is not None:
        floats += [sol.g, sol.prices]
    return device_mod.start_readback(torch.cat([
        *_plan_parts(sol, rates, n),
        torch.cat([t.to(torch.float32) for t in floats]).view(torch.int32),
    ]))


def finalize_plan(
    pending: PendingSolve, fetch_carries: bool = True
) -> GlobalPlan:
    """Wait for the solve's readback and pack it into a GlobalPlan.

    One readback per cycle, as the reference's one batched ``device_get``
    (``_enqueue_readback``); waiting for it is the cycle's last host sync
    and waits for this solve only. The iteration counts are already on the
    host. ``fetch_carries`` decides whether the plan's ``warm_g`` /
    ``warm_price`` dicts are built from the g and prices in the buffer.
    ``solve_ms`` runs from the end of the snapshot to the end of the
    wait, ``dispatch_ms`` to the dispatch's return, and
    ``readback_wait_ms`` is the wait alone. The refresh's span record,
    when the pending solve carries one, adds its keys
    (``RefreshSpans.resolve``)."""
    cols, sol, spans = pending.cols, pending.sol, pending.spans
    m_pad = sol.load.shape[0]
    n = len(cols.model_ids)
    rb = pending.readback
    if rb is None:
        rates = device_mod.upload(cols.rates, sol.indices.device)
        rb = _enqueue_readback(sol, rates, n)
    t_wait = time.perf_counter()
    with tracing.record_span(spans, "readback_wait"):
        host = device_mod.finish_readback(rb).numpy()
    t2 = time.perf_counter()
    with tracing.record_span(spans, "extract"):
        # Hottest-first order (publishers truncate from the tail), taken
        # and compacted on the device: only the ids move here. Scattered
        # by rank, the ids are read in row order, the order they were
        # allocated in, not in the hottest-first one: fewer cache misses.
        rank, counts, flat, scalars = _unpack_plan(
            host, n, sol.indices.shape[1])
        flat = flat[:int(counts.sum(dtype=np.int64))]
        ids = np.empty(n, dtype=object)
        ids[rank] = _id_array(cols.model_ids)
        model_ids = ids.tolist()
    t3 = time.perf_counter()
    plan = GlobalPlan.from_columnar(
        model_ids, counts, flat, cols.instance_ids, now_ms(),
        (t3 - pending.t_start) * 1e3,
    )
    plan.stats = {
        "snapshot_ms": (pending.t_snapshot - pending.t_start) * 1e3,
        "solve_ms": (t2 - pending.t_snapshot) * 1e3,
        "extract_ms": (t3 - t2) * 1e3,
        "readback_wait_ms": (t2 - t_wait) * 1e3,
        "warm": pending.warm,
        "solver_path": pending.path,
        pending.impl_knob: pending.impl,
        "overflow": float(scalars[0]),
        "row_err": float(scalars[1]),
        "sinkhorn_iters_run": sol.sinkhorn_iters_run,
        "auction_iters_run": sol.auction_iters_run,
        # The dispatch's syncs and the readback's wait.
        "host_syncs": pending.dispatch_syncs + 1,
        "readback_bytes": host.nbytes,
    }
    if pending.t_dispatched is not None:
        plan.stats["dispatch_ms"] = (
            pending.t_dispatched - pending.t_snapshot) * 1e3
    if pending.topk:
        plan.stats["topk"] = pending.topk
    if pending.dirty_rows is not None:
        plan.stats["dirty_rows"] = pending.dirty_rows
    if fetch_carries and len(scalars) == 2 + 2 * m_pad:
        m = len(cols.instance_ids)
        g_arr = scalars[2:2 + m_pad][:m]
        p_arr = scalars[2 + m_pad:][:m]
        plan.warm_g = dict(zip(cols.instance_ids, g_arr.astype(float).tolist()))
        plan.warm_price = dict(
            zip(cols.instance_ids, p_arr.astype(float).tolist())
        )
    if spans is not None:
        spans.resolve(plan.stats)
    return plan


def solve_plan(
    models: Sequence[tuple[str, ModelRecord]],
    instances: Sequence[tuple[str, InstanceRecord]],
    rpm_fn: Optional[RpmSource] = None,
    seed: int = 0,
    constraints=None,
    warm_g: Optional[Mapping[str, float]] = None,
    config=None,
    warm_price: Optional[Mapping[str, float]] = None,
    cols: Optional[ProblemColumns] = None,
    *,
    mesh=None,
    device=None,
) -> GlobalPlan:
    """One global solve -> GlobalPlan (blocking): snapshot (unless
    ``cols`` is given), ``dispatch_solve`` on ``device`` (or sharded over
    ``mesh``), then ``finalize_plan``. Stage timings and the refresh's
    spans land in ``plan.stats``."""
    if not models or not instances:
        return GlobalPlan({}, now_ms(), 0.0)
    with tracing.RefreshSpans().current():
        t0 = time.perf_counter()
        if cols is None:
            with tracing.refresh_span("snapshot"):
                cols = snapshot_columns(
                    models, instances, rpm_fn, constraints=constraints
                )
        t1 = time.perf_counter()
        pending = dispatch_solve(
            cols, seed=seed, mesh=mesh, warm_g=warm_g,
            warm_price=warm_price, config=config, t_start=t0,
            t_snapshot=t1, device=device,
        )
        return finalize_plan(pending)


def auto_mesh():
    """The strategy's ``mesh="auto"``: the largest power-of-two set of CUDA
    devices, all on the model axis (bucket-padded shapes are 2^k or
    3 * 2^k, so a power-of-two axis divides them), or None when that is
    one device or none."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    usable = 1 << (count.bit_length() - 1) if count else 0
    if usable <= 1:
        return None
    return mesh_mod.make_mesh(
        devices=[torch.device("cuda", i) for i in range(usable)]
    )


class TorchPlacementStrategy(PlacementStrategy):
    """Plan-serving strategy with a fallback behind it: the port of
    ``JaxPlacementStrategy``.

    ``refresh(models, instances, rpm_fn, incremental=...)`` solves a plan
    (the leader calls it periodically and publishes the result); decisions
    read the latest plan without a lock and fall back to ``fallback``
    (the port's ``GreedyStrategy`` unless one is handed in, as in the
    reference) on any miss (model not in the plan, planned instances all
    excluded, plan older than ``plan_ttl_ms``). An incremental refresh patches the cached
    snapshot for the records marked dirty (``mark_dirty``) and, for small
    model-only churn under a matching noise epoch, re-solves only the
    dirty rows against the last full solve's frozen column state
    (``SolveBase``); otherwise it runs a full warm solve.

    Differences from the reference:

    - ``device=None`` means ``cuda:0`` and raises without a CUDA device
      (``device.resolve_device``); ``device="cpu"`` runs the plain
      versions. With a mesh it means the mesh's first device.
    - ``mesh``: None solves on ``device``; a ``parallel.mesh.Mesh``
      shards every refresh over it, with the incremental path off, as in
      the reference; "auto" takes the largest power-of-two set of CUDA
      devices, and None when that is one device (or none).
    - The locks are plain ``threading.Lock``s.
    """

    def __init__(
        self,
        plan_ttl_ms: int = 15 * 60_000,
        fallback: Optional[PlacementStrategy] = None,
        constraints=None,
        mesh=None,
        solve_config="env",
        *,
        device=None,
    ):
        if mesh == "auto":
            mesh = auto_mesh()
        if mesh is not None and not isinstance(mesh, mesh_mod.Mesh):
            raise NotImplementedError(
                f"mesh must be a modelmesh_tpu_torch.parallel.mesh.Mesh, "
                f"'auto' or None (got {type(mesh).__name__})"
            )
        self.mesh = mesh
        self.plan_ttl_ms = plan_ttl_ms
        self.fallback = fallback or GreedyStrategy()
        # Type constraints (duck-typed is_candidate/is_preferred) the
        # solves honor.
        self.constraints = constraints
        self.device = _solve_device(mesh, device)
        # "env" -> MM_SOLVER_* knobs; None -> the defaults; or a config.
        if solve_config == "env":
            cfg = solve_config_from_env()
            solve_config = None if cfg == SolveConfig() else cfg
        self.solve_config = solve_config
        self._plan: Optional[GlobalPlan] = None
        # Plan generation (always increments) is separate from the noise
        # seed: incremental refreshes freeze the noise epoch, and the seed
        # rotates only on full rebuilds.
        self._generation = 0
        self._seed = 0
        self._refresh_lock = threading.Lock()
        self._warm_g: Optional[dict[str, float]] = None
        self._warm_price: Optional[dict[str, float]] = None
        # Delta-snapshot state: the cached columns and the dirty marks
        # since the last refresh (id -> highest record version announced;
        # 0 = unknown). _dirty_lock is separate, so event threads never
        # wait behind a solve.
        self._snap_cache: Optional[SnapshotCache] = None
        self._dirty_lock = threading.Lock()
        self._dirty_models: dict = {}
        self._dirty_instances: dict = {}
        # Consecutive delta refreshes since the last full rebuild.
        self._delta_streak = 0
        # The last full solve's frozen state: the incremental path's merge
        # target. Dropped on a seed rotation, a fleet resize or a failed
        # quality gate.
        self._base: Optional[SolveBase] = None
        # Dirty-row fraction ceiling of the incremental re-solve; 0 turns
        # the path off.
        self.incr_max_dirty_frac = envs.get_float(
            "MM_SOLVER_INCREMENTAL_MAX_DIRTY_FRAC"
        )

    @property
    def plan(self) -> Optional[GlobalPlan]:
        return self._plan

    def mark_dirty(
        self, models: Sequence = (), instances: Sequence = ()
    ) -> None:
        """Record churned records for the next ``refresh(incremental=True)``.

        Every model or instance whose record changed since the last
        refresh must be marked, or the delta snapshot serves stale columns
        for it until the next full rebuild. Entries are bare ids or
        ``(id, record_version)`` pairs: a versioned mark whose version is
        newer than the record the refresh patched from is re-queued
        (``_requeue_stale_marks_locked``)."""
        with self._dirty_lock:
            for entry in models:
                mid, ver = entry if isinstance(entry, tuple) else (entry, 0)
                if ver >= self._dirty_models.get(mid, 0):
                    self._dirty_models[mid] = ver
            for entry in instances:
                iid, ver = entry if isinstance(entry, tuple) else (entry, 0)
                if ver >= self._dirty_instances.get(iid, 0):
                    self._dirty_instances[iid] = ver

    def _take_dirty(self) -> tuple[dict, dict]:
        """The marks since the last refresh, consumed; their counts are
        the refresh's ``dirty_models`` / ``dirty_instances``."""
        with self._dirty_lock:
            dm, di = self._dirty_models, self._dirty_instances
            self._dirty_models, self._dirty_instances = {}, {}
        tracing.refresh_count("dirty_models", len(dm))
        tracing.refresh_count("dirty_instances", len(di))
        return dm, di

    def _requeue_stale_marks_locked(self, dm, di, models, instances) -> None:
        """Re-queue consumed marks whose record version is newer than the
        record in the list just snapshotted: the event landed between the
        caller's list read and ``_take_dirty``, so its change is not in
        the columns yet."""
        cache = self._snap_cache
        if cache is None:
            return
        stale_m = [
            (mid, ver) for mid, ver in dm.items()
            if ver
            and (i := cache.model_pos.get(mid)) is not None
            and models[i][1].version < ver
        ]
        stale_i = [
            (iid, ver) for iid, ver in di.items()
            if ver
            and (j := cache.inst_pos.get(iid)) is not None
            and instances[j][1].version < ver
        ]
        if stale_m or stale_i:
            self.mark_dirty(stale_m, stale_i)

    def _build_cols_locked(self, models, instances, rpm_fn, incremental: bool):
        """Delta-patch the cached snapshot when allowed, else rebuild it
        (the refresh span ``snapshot``). Returns (cols, was_delta,
        dirty_models, dirty_instances)."""
        with tracing.refresh_span("snapshot"):
            dm, di = self._take_dirty()
            if (
                incremental
                and self._snap_cache is not None
                and self._delta_streak < MAX_DELTA_STREAK
            ):
                cols = patch_columns(
                    self._snap_cache, models, instances, rpm_fn,
                    set(dm), set(di), constraints=self.constraints,
                )
                if cols is not None:
                    self._delta_streak += 1
                    self._requeue_stale_marks_locked(dm, di, models, instances)
                    return cols, True, dm, di
            cols, self._snap_cache = snapshot_columns(
                models, instances, rpm_fn, constraints=self.constraints,
                return_cache=True,
            )
            self._delta_streak = 0
            self._requeue_stale_marks_locked(dm, di, models, instances)
            return cols, False, dm, di

    def _epoch_carries_locked(self, delta: bool):
        """Noise-epoch discipline: a delta refresh keeps the seed and may
        warm-start prices; a full rebuild rotates the seed and drops the
        price carry, which only means something under the draw it was
        selected with. g is draw-independent and always carries. Returns
        the (warm_g, warm_price) dicts to use."""
        if not delta:
            self._seed += 1
            self._warm_price = None
        return self._warm_g, self._warm_price

    def _incremental_rows_locked(self, cols, delta, dm, di):
        """Dirty row ids for an incremental re-solve, or None for a full
        solve: on a mesh; after a full rebuild or without a base; when the
        base's
        seed or padded shapes differ; when any instance is dirty (column
        churn moves every row's costs); under threefry noise; and when the
        dirty-model fraction exceeds ``incr_max_dirty_frac``. Clean rows
        whose rate drifted past RATE_DRIFT_FRAC of the base's hottest rate
        join the set first, and the ceiling applies to the joined set."""
        base = self._base
        if (
            not delta or base is None or di or not dm
            or self.mesh is not None or self.incr_max_dirty_frac <= 0
            or base.seed != self._seed
        ):
            return None
        cfg = self.solve_config
        if cfg is not None and cfg.tau > 0 and cfg.noise_impl != "hash":
            return None
        n = len(cols.model_ids)
        if (
            base.indices.shape[0] != _bucket(n)
            or base.g.shape[0] != _bucket(len(cols.instance_ids), 64)
        ):
            return None
        cache = self._snap_cache
        rows = set()
        for mid in dm:
            i = None if cache is None else cache.model_pos.get(mid)
            if i is None:
                return None
            rows.add(i)
        if base.rates is not None and len(base.rates) >= n:
            cur = np.asarray(cols.rates, np.float32)[:n]
            scale = float(base.rates[:n].max()) if n else 0.0
            if scale > 0.0:
                drifted = np.nonzero(
                    np.abs(cur - base.rates[:n]) > RATE_DRIFT_FRAC * scale
                )[0]
                rows.update(int(i) for i in drifted)
        if len(rows) > self.incr_max_dirty_frac * n:
            return None
        return sorted(rows)

    def _solve_locked(self, cols, delta, dm, di, t0):
        """The incremental re-solve when the gates allow, with the
        overflow quality fallback; else a full warm solve, whose frozen
        state becomes the next base."""
        rows = self._incremental_rows_locked(cols, delta, dm, di)
        if rows is not None:
            pending = dispatch_solve(
                cols, seed=self._seed, config=self.solve_config,
                base=self._base, dirty_rows=rows, t_start=t0,
                device=self.device,
            )
            plan = finalize_plan(pending)
            demand = float(np.sum(cols.sizes * cols.copies))
            budget = self._base.overflow + INCREMENTAL_OVERFLOW_FRAC * max(
                demand, 1e-9
            )
            if plan.stats["overflow"] <= budget:
                # The merge target advances; the column state and the
                # overflow reference stay frozen at the full solve.
                self._base = self._base._replace(
                    indices=pending.sol.indices, valid=pending.sol.valid
                )
                return plan
            log.info(
                "incremental re-solve overflow %.3g drifted past the "
                "base solve's %.3g + %.2f%% of demand; falling back to "
                "a full solve",
                plan.stats["overflow"], self._base.overflow,
                INCREMENTAL_OVERFLOW_FRAC * 100,
            )
            self._base = None
        warm_g, warm_price = self._epoch_carries_locked(delta)
        pending = dispatch_solve(
            cols, seed=self._seed, mesh=self.mesh, warm_g=warm_g,
            warm_price=warm_price, config=self.solve_config, t_start=t0,
            device=self.device,
        )
        plan = finalize_plan(pending)
        sol = pending.sol
        self._base = SolveBase(
            indices=sol.indices, valid=sol.valid, g=sol.g,
            prices=sol.prices, row_err=sol.row_err, seed=self._seed,
            overflow=plan.stats["overflow"],
            rates=np.asarray(cols.rates, np.float32).copy(),
        )
        return plan

    def refresh(
        self,
        models: Sequence[tuple[str, ModelRecord]],
        instances: Sequence[tuple[str, InstanceRecord]],
        rpm_fn: Optional[RpmSource] = None,
        incremental: bool = False,
    ) -> GlobalPlan:
        with self._refresh_lock:
            self._generation += 1
            delta = None
            if models and instances:
                with tracing.RefreshSpans().current():
                    t0 = time.perf_counter()
                    cols, delta, dm, di = self._build_cols_locked(
                        models, instances, rpm_fn, incremental
                    )
                    plan = self._solve_locked(cols, delta, dm, di, t0)
            else:
                # Empty view: no solve, so the seed does not rotate and
                # the carries stay paired with the current draw.
                plan = solve_plan(
                    models, instances, rpm_fn, seed=self._seed,
                    constraints=self.constraints, warm_g=self._warm_g,
                    config=self.solve_config, warm_price=self._warm_price,
                    mesh=self.mesh, device=self.device,
                )
            # Keep the carries across empty-snapshot blips.
            if plan.warm_g is not None:
                self._warm_g = plan.warm_g
            if plan.warm_price is not None:
                self._warm_price = plan.warm_price
            if delta is not None:
                plan.stats["delta_snapshot"] = delta
            plan.generation = self._generation
            self._plan = plan
            log.info(
                "placement plan refreshed: %d models x %d instances in %.1f ms",
                plan.num_models(), len(instances), plan.solve_ms,
            )
            return plan

    def adopt(self, plan: Optional[GlobalPlan]) -> None:
        """Install a plan published by the leader (None clears)."""
        self._plan = plan

    # -- SPI ----------------------------------------------------------------

    def choose_load_target(
        self, req: PlacementRequest, view: ClusterView
    ) -> Optional[str]:
        plan = self._plan
        if plan is not None and plan.age_ms() <= self.plan_ttl_ms:
            desired = plan.lookup(req.model_id)
            if desired:
                live = {iid for iid, rec in view.placeable()}
                for iid in desired:
                    if iid in req.exclude or iid not in live:
                        continue
                    if iid in req.model.instance_ids:
                        continue  # already loaded there
                    return LOAD_HERE if iid == req.requesting_instance else iid
        return self.fallback.choose_load_target(req, view)

    def choose_group_targets(
        self, req: PlacementRequest, view: ClusterView,
        shard_count: int, shard_units: int,
    ) -> Optional[dict[str, int]]:
        """The plan's instances for this model become the group's
        preferred members, sticky members kept; the fallback's group
        planner tops the group up to ``shard_count``."""
        keep: dict[str, int] = {}
        taken: set[int] = set()
        for iid, idx in req.model.shard_instances.items():
            if (
                0 <= idx < shard_count
                and idx not in taken
                and iid not in req.exclude
                and iid in view.live_map
                and not view.live_map[iid].draining
            ):
                keep[iid] = idx
                taken.add(idx)
        plan = self._plan
        if plan is not None and plan.age_ms() <= self.plan_ttl_ms:
            live = view.live_map
            missing = [i for i in range(shard_count) if i not in taken]
            for iid in plan.lookup(req.model_id) or ():
                if not missing:
                    break
                rec = live.get(iid)
                if (
                    iid in keep or iid in req.exclude or rec is None
                    or rec.disabled or rec.draining
                    or rec.free_units < shard_units
                ):
                    continue
                idx = missing.pop(0)
                keep[iid] = idx
                taken.add(idx)
        if len(taken) == shard_count:
            return keep
        # Top up the rest through the fallback, with the adopted members
        # held sticky by a request whose record claims them.
        merged = dict(req.model.shard_instances)
        merged.update(keep)
        model = req.model
        if merged != model.shard_instances:
            model = copy.deepcopy(req.model)
            model.shard_instances = merged
            synth = dataclasses.replace(req, model=model)
        else:
            synth = req
        return self.fallback.choose_group_targets(
            synth, view, shard_count, shard_units
        )

    def choose_serve_target(
        self, model: ModelRecord, view: ClusterView, exclude: frozenset[str]
    ) -> Optional[str]:
        # Serve balancing stays local: it needs fresh busyness, not a
        # global solve.
        return self.fallback.choose_serve_target(model, view, exclude)

    def rank_serve_candidates(
        self, model: ModelRecord, view: ClusterView, exclude: frozenset[str]
    ):
        return self.fallback.rank_serve_candidates(model, view, exclude)
