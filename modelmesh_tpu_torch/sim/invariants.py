"""The port's own copy of the JAX package's ``sim/invariants.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Machine-checked cluster invariants, run at scenario quiescence.

Each checker returns a list of violation strings (empty = PASS). They are
deliberately *quiescent-state* properties: mid-scenario the cluster is
allowed to be inconsistent (that's what convergence protocols are for);
after faults stop and enough virtual time passes for the janitor/reaper
cadences to run, these must hold.

Catalog (see docs/testing.md for the rationale of each):
- ``demanded_models_served``  — every model the scenario demanded has at
  least one ACTIVE copy on a live instance, or a recorded load failure,
  or was unregistered.
- ``no_dead_placements``      — no registry record points at an instance
  that has been dead longer than the reaper prune grace.
- ``registry_cache_convergence`` — live instances' ACTIVE cache entries
  and the registry's placement maps agree in both directions.
- ``vmodel_resolution_acyclic``  — vmodel target resolution terminates
  (no alias cycles, active targets exist in the registry).
- ``cache_weight_consistent`` — per instance: the cache's accounted
  weight equals the sum of entry weights, never exceeds capacity, and
  pending-unload units are non-negative; the host staging tier obeys the
  same conservation law in bytes against its own budget.
- ``host_claims_converged`` — registry host-tier claims
  (transfer/ demotions) on LIVE instances have an actual host-resident
  snapshot behind them.
- ``draining_deregistered`` — the DRAINING vocabulary (reconfig/): a
  live instance still advertising ``draining`` at quiescence has
  finished its drain, so no registry placement may point at it. Without
  this term the suite would misread a drained-but-alive pod's leftover
  placements as some other checker's problem (it is neither a dead
  placement — the pod is alive — nor a cache mismatch once the local
  copy is gone).
- ``copy_bounds`` — no record holds more placements than the fleet's
  per-model ceiling (``TaskConfig.max_copies``): the autoscale
  controller's hard cap, and the first place a runaway scale-up loop
  would show.
- ``group_complete_or_absent`` — sharded placement groups are
  all-or-nothing: every record either carries no group or a complete
  one whose live members' local entries agree with the claims.

``slo_attained(spec)`` is a FACTORY, not part of the standard suite:
scenarios attach it via ``extra_checks`` with their own objective spec.
Unlike the quiescent checkers it judges the OBSERVED probe traffic —
windowed p99/availability over the whole run's virtual timeline, a
violation string per failing virtual checkpoint — so a mid-run latency
spike fails the scenario even if the cluster later converges.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from modelmesh_tpu_torch.serving.entry import EntryState

if TYPE_CHECKING:  # pragma: no cover
    from modelmesh_tpu_torch.sim.harness import SimCluster


def demanded_models_served(cluster: "SimCluster") -> list[str]:
    out: list[str] = []
    inst = cluster.first_live().instance
    active: dict[str, set[str]] = {}
    for pod in cluster.live_pods():
        for mid in pod.instance.cache.keys():
            ce = pod.instance.cache.get_quietly(mid)
            if ce is not None and ce.state.is_servable:
                active.setdefault(mid, set()).add(pod.iid)
    for mid in sorted(cluster.demanded):
        mr = inst.registry.get(mid)
        if mr is None:
            continue  # unregistered (or lost demand) — nothing owed
        if active.get(mid):
            continue
        if mr.load_failures:
            continue  # failure record IS the answer (fail-fast, not silence)
        out.append(
            f"demanded model {mid} has no ACTIVE copy and no failure "
            f"record (placements={sorted(mr.all_placements)})"
        )
    return out


def no_dead_placements(
    cluster: "SimCluster", dead_since_ms: dict[str, int], now_ms: int,
    grace_ms: int,
) -> list[str]:
    """``dead_since_ms``: instance -> virtual time it died (scenario
    bookkeeping). ``grace_ms`` should be assume_gone_ms + one reaper
    interval — the window the protocol legitimately allows."""
    out: list[str] = []
    inst = cluster.first_live().instance
    for mid, mr in inst.registry.items():
        for iid in sorted(mr.all_placements):
            died = dead_since_ms.get(iid)
            if died is not None and now_ms - died > grace_ms:
                out.append(
                    f"record {mid} still points at {iid}, dead for "
                    f"{(now_ms - died) / 1000.0:.0f}s (> grace "
                    f"{grace_ms / 1000.0:.0f}s)"
                )
    return out


def registry_cache_convergence(cluster: "SimCluster") -> list[str]:
    out: list[str] = []
    inst = cluster.first_live().instance
    records = dict(inst.registry.items())
    for pod in cluster.live_pods():
        mmi = pod.instance
        for mid in mmi.cache.keys():
            ce = mmi.cache.get_quietly(mid)
            if ce is None or not ce.state.is_servable:
                continue
            mr = records.get(mid)
            if mr is None:
                out.append(
                    f"{pod.iid} serves {mid} but the registry has no record"
                )
            elif pod.iid not in mr.instance_ids:
                out.append(
                    f"{pod.iid} serves {mid} but the record does not list "
                    f"it (instance_ids={sorted(mr.instance_ids)})"
                )
    for mid, mr in records.items():
        for iid in sorted(mr.instance_ids):
            pod = next((p for p in cluster.live_pods() if p.iid == iid), None)
            if pod is None:
                continue  # dead holders are no_dead_placements' concern
            ce = pod.instance.cache.get_quietly(mid)
            # Servable covers ACTIVE plus the other promoted-to-registry
            # states (PARTIAL mid-stream, SHARDED group members).
            if ce is None or (
                not ce.state.is_servable
                and not ce.state.is_loading
            ):
                out.append(
                    f"record {mid} lists {iid} but that instance has no "
                    f"usable copy (entry={ce.state.value if ce else 'none'})"
                )
    return out


def vmodel_resolution_acyclic(cluster: "SimCluster") -> list[str]:
    """Vmodels resolve alias -> concrete model. A target naming another
    vmodel id (aliases-of-aliases) must terminate; active targets must
    exist in the registry."""
    out: list[str] = []
    inst = cluster.first_live().instance
    from modelmesh_tpu_torch.kv.table import KVTable
    from modelmesh_tpu_torch.records import VModelRecord

    table: KVTable[VModelRecord] = KVTable(
        inst.store, f"{inst.config.kv_prefix}/vmodels", VModelRecord
    )
    vmodels = dict(table.items())
    for vmid, vr in vmodels.items():
        seen = {vmid}
        cur = vr.active_model
        while cur in vmodels:
            if cur in seen:
                out.append(f"vmodel resolution cycle through {sorted(seen)}")
                break
            seen.add(cur)
            cur = vmodels[cur].active_model
        else:
            if cur and inst.registry.get(cur) is None:
                out.append(
                    f"vmodel {vmid} resolves to {cur}, which is not in "
                    "the registry"
                )
    return out


def cache_weight_consistent(cluster: "SimCluster") -> list[str]:
    out: list[str] = []
    for pod in cluster.live_pods():
        cache = pod.instance.cache
        with cache.eviction_lock:
            accounted = cache.weight
            actual = sum(e.weight for e in cache._entries.values())
            capacity = cache.capacity
        if accounted != actual:
            out.append(
                f"{pod.iid}: cache weight {accounted} != sum of entry "
                f"weights {actual} (double-counted or leaked units)"
            )
        if accounted > capacity:
            out.append(
                f"{pod.iid}: cache weight {accounted} exceeds capacity "
                f"{capacity}"
            )
        if pod.instance.unload_tracker.pending_units < 0:
            out.append(f"{pod.iid}: negative pending-unload units")
        # Host-tier byte accounting (transfer/): same conservation law
        # one tier down — accounted bytes equal the sum of resident
        # snapshot sizes and never exceed the host budget.
        tier = pod.instance.host_tier
        with tier._lock:
            host_used = tier.used_bytes
            host_actual = sum(e[1] for e in tier._copies.values())
            host_cap = tier.capacity_bytes
        if host_used != host_actual:
            out.append(
                f"{pod.iid}: host tier accounts {host_used}B but holds "
                f"{host_actual}B (leaked or double-counted snapshot)"
            )
        if host_used > host_cap:
            out.append(
                f"{pod.iid}: host tier {host_used}B exceeds budget "
                f"{host_cap}B"
            )
    return out


def host_claims_converged(cluster: "SimCluster") -> list[str]:
    """Registry host-tier claims and actual host-resident snapshots agree
    for LIVE instances: a claim with no snapshot behind it sends
    receivers to a source that will answer NOT_AVAILABLE forever (dead
    holders are the reaper's job, with the standard grace)."""
    out: list[str] = []
    inst = cluster.first_live().instance
    live = {p.iid: p for p in cluster.live_pods()}
    for mid, mr in inst.registry.items():
        for iid in sorted(getattr(mr, "host_instances", {})):
            pod = live.get(iid)
            if pod is None:
                continue
            if pod.instance.host_tier.peek(mid) is None:
                out.append(
                    f"record {mid} claims a host copy on {iid} but that "
                    "instance holds no snapshot"
                )
    return out


def draining_deregistered(cluster: "SimCluster") -> list[str]:
    """A LIVE instance still advertising DRAINING at quiescence has
    completed (or deadline-swept) its drain: every local copy was
    migrated/deregistered, so a registry placement or loading claim
    still pointing at it is a drain that lost state — not a dead
    placement (the pod is alive) and invisible to the cache-convergence
    check (the local cache is already empty)."""
    out: list[str] = []
    draining = {
        p.iid for p in cluster.live_pods() if p.instance.draining
    }
    if not draining:
        return out
    inst = cluster.first_live().instance
    for mid, mr in inst.registry.items():
        for iid in sorted(mr.all_placements):
            if iid in draining:
                out.append(
                    f"record {mid} still places on {iid}, which finished "
                    "draining (deregistration lost?)"
                )
    return out


def copy_bounds(cluster: "SimCluster") -> list[str]:
    """No registry record may hold more placements than the fleet's
    configured per-model ceiling (``TaskConfig.max_copies``) — the
    autoscale controller's hard cap, and a sanity bound every scenario
    should respect (a runaway scale-up loop shows here before it shows
    anywhere else)."""
    out: list[str] = []
    cap = cluster.task_config.max_copies
    inst = cluster.first_live().instance
    for mid, mr in inst.registry.items():
        if mr.copy_count > cap:
            out.append(
                f"record {mid} holds {mr.copy_count} copies "
                f"(> max_copies {cap}): {sorted(mr.all_placements)}"
            )
    return out


def group_complete_or_absent(cluster: "SimCluster") -> list[str]:
    """Sharded placement groups are all-or-nothing at quiescence: a
    record either carries NO group (``shard_count`` 0 and no shard
    claims) or a COMPLETE one — every shard index 0..K-1 held by a live,
    promoted member whose LOCAL cache entry agrees on its coordinates.
    A lingering partial group means the atomic plan/evict rules lost a
    member without tearing the group down (exactly the state routing
    must never see)."""
    out: list[str] = []
    inst = cluster.first_live().instance
    live = {p.iid: p for p in cluster.live_pods()}
    for mid, mr in inst.registry.items():
        count = getattr(mr, "shard_count", 0)
        shards = dict(getattr(mr, "shard_instances", {}) or {})
        if not count:
            if shards:
                out.append(
                    f"record {mid} carries shard claims "
                    f"{sorted(shards.items())} with shard_count=0"
                )
            continue
        held = {
            idx for iid, idx in shards.items()
            if iid in mr.instance_ids and iid in live
        }
        missing = sorted(set(range(count)) - held)
        if missing:
            out.append(
                f"record {mid} {count}-way group incomplete: no live "
                f"holder for indices {missing} "
                f"(claims={sorted(shards.items())})"
            )
        for iid, idx in sorted(shards.items()):
            pod = live.get(iid)
            if pod is None or iid not in mr.instance_ids:
                continue  # loading claim / dead holder: judged above
            ce = pod.instance.cache.get_quietly(mid)
            if (
                ce is None or not ce.is_shard
                or ce.shard_index != idx or ce.shard_count != count
            ):
                got = (
                    f"shard {ce.shard_index}/{ce.shard_count}"
                    if ce is not None and ce.is_shard
                    else (ce.state.value if ce is not None else "none")
                )
                out.append(
                    f"record {mid} claims shard {idx}/{count} on {iid} "
                    f"but the local entry is {got}"
                )
    return out


def slo_attained(spec: str, window_ms: int = 10_000, min_requests: int = 1,
                 model_filter=None, slo_class: str = "",
                 judge_after_ms: int = 0):
    """Machine-checked SLO attainment over the scenario's observed probe
    traffic (``SimCluster.request_log``: virtual ts, model, ok, error,
    virtual latency). The run's virtual timeline is cut into
    ``window_ms`` checkpoints; every checkpoint with at least
    ``min_requests`` completions must meet the spec's objectives
    (observability/slo.py grammar). Returns the standard checker shape:
    one violation string per failing checkpoint; a run with NO evaluated
    checkpoint fails as vacuous.

    ``model_filter`` restricts the judged traffic (e.g. one model-class
    prefix — how the overload scenario asserts per-class divergence);
    ``slo_class`` names both the spec clause to judge by and the class
    tag in violation strings (default: the spec's 'default' clause
    judging everything the filter admits).

    ``judge_after_ms`` drops samples earlier than that many virtual ms
    after the FIRST filtered sample — the detection-ramp allowance for
    REACTIVE controllers (PR-14 house style): an autoscaler or admission
    throttle cannot promise no-breach while its burn window is still
    accumulating evidence, so the judged property is "the SLO holds once
    the controller has had its detection window", with the ramp's
    duration pinned explicitly in the scenario. The vacuity guard still
    applies to what remains."""
    from modelmesh_tpu_torch.observability.slo import (
        _percentile,
        parse_slo_spec,
    )

    objectives = parse_slo_spec(spec)
    obj = (
        objectives.get(slo_class)
        or objectives.get("default")
        or next(iter(objectives.values()))
    )
    tag = f"[{slo_class}] " if slo_class else ""

    def check(cluster: "SimCluster") -> list[str]:
        log_ = list(cluster.request_log)
        if model_filter is not None:
            log_ = [row for row in log_ if model_filter(row[1])]
        if not log_:
            return [f"{tag}no probe requests observed (vacuous SLO run)"]
        out: list[str] = []
        if judge_after_ms:
            ramp_end = min(t for t, *_ in log_) + judge_after_ms
            log_ = [row for row in log_ if row[0] >= ramp_end]
            if not log_:
                return [
                    f"{tag}no probe requests after the {judge_after_ms}ms "
                    "detection ramp (vacuous SLO run)"
                ]
        base = min(t for t, *_ in log_)
        windows: dict[int, list[tuple[float, bool]]] = {}
        for t, _mid, ok, _err, latency_ms in log_:
            windows.setdefault((t - base) // window_ms, []).append(
                (latency_ms, ok)
            )
        evaluated = 0
        for idx in sorted(windows):
            samples = windows[idx]
            if len(samples) < min_requests:
                continue
            evaluated += 1
            at = f"{tag}checkpoint @{base + idx * window_ms}ms"
            lat = sorted(v for v, _ in samples)
            n = len(samples)
            avail = sum(1 for _, ok in samples if ok) / n
            for name, q, want in (
                ("p50", 0.50, obj.p50_ms), ("p95", 0.95, obj.p95_ms),
                ("p99", 0.99, obj.p99_ms),
            ):
                if want is None:
                    continue
                got = _percentile(lat, q)
                if got > want:
                    out.append(
                        f"{at}: {name}={got:.0f}ms > {want:g}ms "
                        f"(n={n}, spec {spec!r})"
                    )
            if obj.availability is not None and avail < obj.availability:
                out.append(
                    f"{at}: availability={avail:.4f} < "
                    f"{obj.availability:g} (n={n})"
                )
        if not evaluated:
            out.append(
                f"{tag}no checkpoint reached {min_requests} requests "
                "(vacuous SLO run)"
            )
        return out

    return check


def check_all(
    cluster: "SimCluster",
    dead_since_ms: dict[str, int],
    now_ms: int,
    grace_ms: int,
) -> dict[str, list[str]]:
    """name -> violations (empty list = PASS); stable key order."""
    return {
        "demanded_models_served": demanded_models_served(cluster),
        "no_dead_placements": no_dead_placements(
            cluster, dead_since_ms, now_ms, grace_ms
        ),
        "registry_cache_convergence": registry_cache_convergence(cluster),
        "vmodel_resolution_acyclic": vmodel_resolution_acyclic(cluster),
        "cache_weight_consistent": cache_weight_consistent(cluster),
        "host_claims_converged": host_claims_converged(cluster),
        "draining_deregistered": draining_deregistered(cluster),
        "copy_bounds": copy_bounds(cluster),
        "group_complete_or_absent": group_complete_or_absent(cluster),
    }
