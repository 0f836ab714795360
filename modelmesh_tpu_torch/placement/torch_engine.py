"""Global placement solve dispatch: host snapshot -> device solve -> plan.

Port of the solver half of ``modelmesh_tpu/placement/jax_engine.py``:
``snapshot_columns`` builds a columnar host snapshot of cluster state,
``dispatch_solve`` expands it into a ``PlacementProblem`` on the device and
runs the solve (sparse top-K or the dense tier, by the reference's
dispatch rule), and ``finalize_plan`` reads the result back in one
batched readback and packs it into a ``GlobalPlan``. Plans are advisory:
the serving layer's local guards stay authoritative.

Differences from the reference: the solve's convergence gates run on the
host, so ``dispatch_solve`` returns after the solve's last gate decision
(only the tail of the solve is still in flight); every host sync on the
path is counted (``device.host_syncs``) and reported per solve in
``plan.stats["host_syncs"]``. Meshes, buffer donation and the
incremental dirty-row re-solve are not ported yet.
"""

from __future__ import annotations

import time
from collections.abc import Mapping
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.ops.costs import PlacementProblem
from modelmesh_tpu_torch.ops.sinkhorn import resolve_lse_impl
from modelmesh_tpu_torch.ops.solve import SolveConfig, SolveInit, solve_placement
from modelmesh_tpu_torch.ops.sparse import resolve_sparse_impl
from modelmesh_tpu_torch.records import InstanceRecord, ModelRecord, now_ms
from modelmesh_tpu_torch.utils import envs

RpmSource = Union[Callable[[str], int], Mapping[str, int]]


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


def _rpm_column(rpm_fn: Optional[RpmSource], model_ids, n: int) -> np.ndarray:
    """Per-model rpm read (all zeros without a source)."""
    if rpm_fn is None:
        return np.zeros(n, np.float32)
    lookup = rpm_fn.get if isinstance(rpm_fn, Mapping) else rpm_fn
    return np.fromiter((lookup(mid) or 0 for mid in model_ids), np.float32, n)


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
) -> ProblemColumns:
    """Vectorized host snapshot: one C-speed pass per column.
    ``constraints`` (duck-typed ``is_candidate``/``is_preferred``) builds
    the per-type masks; without it every instance is a candidate."""
    model_ids = [mid for mid, _ in models]
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
    return ProblemColumns(
        model_ids, instance_ids, sizes, copies, rates, loaded_rows,
        loaded_cols, type_idx, req_masks, pref_masks, capacity, reserved,
        lru_age, busy, zone, placeable,
    )


def _bucket(x: int, floor: int = 256) -> int:
    """Next padded size: powers of two plus three-quarter points (<= 33%
    overhead), so drifting fleet sizes reuse a few problem shapes."""
    if x <= floor:
        return floor
    p = 1 << (x - 1).bit_length()  # next power of two >= x
    three_q = (p // 4) * 3
    return three_q if x <= three_q else p


def _expand_problem_device(cols: ProblemColumns, device) -> PlacementProblem:
    """Build the bucket-padded PlacementProblem on ``device``. Padded rows
    are inert (sizes=0, copies=0), padded columns too (placeable=False ->
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
    return _assemble(
        **{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in host.items()}
    )


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

    def _ensure_index(self) -> None:
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
        self._ensure_index()
        row = self._index.get(model_id)
        if row is None:
            return None
        _, counts, flat, inst_ids = self._columnar
        start = int(self._offsets[row])
        end = start + int(counts[row])
        return [inst_ids[j] for j in flat[start:end].tolist()]

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
    tensors; the tail of the solve may still be running)."""

    cols: ProblemColumns
    sol: object          # ops.solve.Placement
    t_start: float       # perf_counter at snapshot start
    t_snapshot: float    # perf_counter when the host snapshot was done
    warm: bool
    path: str = "sparse"
    topk: int = 0
    # The path's kernel knob and the backend that ran (cuda | plain):
    # "sparse_impl" on a sparse solve, "lse_impl" on a dense one.
    impl_knob: str = "sparse_impl"
    impl: str = "cuda"
    syncs_at_start: int = 0     # device.host_syncs when dispatch began


def dispatch_solve(
    cols: ProblemColumns,
    seed: int = 0,
    mesh=None,
    warm_g: Optional[Mapping[str, float]] = None,
    warm_price: Optional[Mapping[str, float]] = None,
    config=None,
    donate: bool = False,
    t_start: Optional[float] = None,
    t_snapshot: Optional[float] = None,
    base=None,
    dirty_rows=None,
    *,
    device=None,
) -> PendingSolve:
    """Expand ``cols`` on ``device`` and run the solve: sparse top-K, or
    the dense tier for small fleets and the MM_SOLVER_SPARSE=0 pin
    (``_resolve_sparse_config``).

    ``device=None`` means the first CUDA device, and raises without one
    (``device.resolve_device``). Warm starts come from the
    ``warm_g``/``warm_price`` per-instance-id dicts of the previous plan
    (instances unknown to them start cold). ``mesh``, ``donate`` and the
    incremental ``base``/``dirty_rows`` are not ported yet and raise, as
    does the dense tier's threefry noise."""
    if mesh is not None:
        raise NotImplementedError("sharded solve: ROADMAP queue 1")
    if donate:
        raise NotImplementedError("buffer donation has no PyTorch port")
    if base is not None or dirty_rows is not None:
        raise NotImplementedError("incremental re-solve: ROADMAP queue 1")
    dev = device_mod.resolve_device(device)
    syncs0 = device_mod.host_syncs
    t_start = time.perf_counter() if t_start is None else t_start
    t_snapshot = time.perf_counter() if t_snapshot is None else t_snapshot
    m_pad = _bucket(len(cols.instance_ids), 64)
    max_copies = int(cols.copies.max()) if len(cols.copies) else 1
    config, sparse = _resolve_sparse_config(config, m_pad, max_copies)
    cfg = SolveConfig() if config is None else config
    if sparse:
        impl_knob, impl = "sparse_impl", resolve_sparse_impl(
            cfg.sparse_impl, dev)
    else:
        impl_knob, impl = "lse_impl", resolve_lse_impl(cfg.lse_impl, dev)

    g0 = np.zeros(m_pad, np.float32)
    price0 = np.zeros(m_pad, np.float32)
    if warm_g:
        for j, iid in enumerate(cols.instance_ids):
            g0[j] = warm_g.get(iid, 0.0)
    if warm_price:
        for j, iid in enumerate(cols.instance_ids):
            price0[j] = warm_price.get(iid, 0.0)
    problem = _expand_problem_device(cols, dev)
    init = SolveInit(
        g0=torch.from_numpy(g0).to(dev), price0=torch.from_numpy(price0).to(dev)
    )
    sol = solve_placement(problem, config=cfg, seed=seed, init=init)
    return PendingSolve(
        cols=cols, sol=sol, t_start=t_start, t_snapshot=t_snapshot,
        warm=bool(warm_g),
        path="sparse" if sparse else "dense",
        topk=cfg.topk if sparse else 0,
        impl_knob=impl_knob, impl=impl,
        syncs_at_start=syncs0,
    )


def _compact_result(sol) -> torch.Tensor:
    """[N, MAX_COPIES + 1] int32: the chosen indices plus the per-row
    valid count (``valid`` is a prefix mask by construction, so the count
    loses nothing)."""
    cnt = sol.valid.sum(dim=1, dtype=torch.int32)
    return torch.cat([sol.indices.to(torch.int32), cnt[:, None]], dim=1)


def finalize_plan(
    pending: PendingSolve, fetch_carries: bool = True
) -> GlobalPlan:
    """Read the solve back and pack it into a GlobalPlan.

    One readback per cycle, as the reference's one batched ``device_get``:
    the packed int32 plan (indices + valid counts) followed by the f32
    values (overflow, row_err and, with ``fetch_carries``, g and prices)
    carried in the same int32 buffer bit for bit. The iteration counts are
    already on the host. ``solve_ms`` runs from the end of the snapshot to
    the end of the readback."""
    cols, sol = pending.cols, pending.sol
    m_pad = sol.load.shape[0]
    floats = [sol.overflow.reshape(1), sol.row_err.reshape(1)]
    if fetch_carries:
        floats += [sol.g, sol.prices]
    plan_dev = _compact_result(sol)
    rows, width = plan_dev.shape
    host = device_mod.readback(torch.cat([
        plan_dev.reshape(-1),
        torch.cat([t.to(torch.float32) for t in floats]).view(torch.int32),
    ])).numpy()
    packed = host[:rows * width].reshape(rows, width)
    scalars = host[rows * width:].view(np.float32)
    t2 = time.perf_counter()
    n = len(cols.model_ids)
    idxa = packed[:n, :-1]
    counts = packed[:n, -1].astype(np.uint8)
    # Hottest-first order: publishers truncate from the tail.
    order = np.argsort(-cols.rates, kind="stable")
    idxo = idxa[order]
    counts = counts[order]
    valid = np.arange(idxo.shape[1], dtype=np.uint8)[None, :] < counts[:, None]
    flat = idxo[valid]
    model_ids = [cols.model_ids[i] for i in order.tolist()]
    t3 = time.perf_counter()
    plan = GlobalPlan.from_columnar(
        model_ids, counts, flat, cols.instance_ids, now_ms(),
        (t3 - pending.t_start) * 1e3,
    )
    plan.stats = {
        "snapshot_ms": (pending.t_snapshot - pending.t_start) * 1e3,
        "solve_ms": (t2 - pending.t_snapshot) * 1e3,
        "extract_ms": (t3 - t2) * 1e3,
        "warm": pending.warm,
        "solver_path": pending.path,
        pending.impl_knob: pending.impl,
        "overflow": float(scalars[0]),
        "row_err": float(scalars[1]),
        "sinkhorn_iters_run": sol.sinkhorn_iters_run,
        "auction_iters_run": sol.auction_iters_run,
        "host_syncs": device_mod.host_syncs - pending.syncs_at_start,
    }
    if pending.topk:
        plan.stats["topk"] = pending.topk
    if fetch_carries:
        m = len(cols.instance_ids)
        g_arr = scalars[2:2 + m_pad][:m]
        p_arr = scalars[2 + m_pad:][:m]
        plan.warm_g = dict(zip(cols.instance_ids, g_arr.astype(float).tolist()))
        plan.warm_price = dict(
            zip(cols.instance_ids, p_arr.astype(float).tolist())
        )
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
    device=None,
) -> GlobalPlan:
    """One global solve -> GlobalPlan (blocking): snapshot (unless
    ``cols`` is given), ``dispatch_solve`` on ``device``, then
    ``finalize_plan``. Stage timings land in ``plan.stats``."""
    if not models or not instances:
        return GlobalPlan({}, now_ms(), 0.0)
    t0 = time.perf_counter()
    if cols is None:
        cols = snapshot_columns(
            models, instances, rpm_fn, constraints=constraints
        )
    t1 = time.perf_counter()
    pending = dispatch_solve(
        cols, seed=seed, warm_g=warm_g, warm_price=warm_price,
        config=config, t_start=t0, t_snapshot=t1, device=device,
    )
    return finalize_plan(pending)
