"""The port's own copy of the JAX package's ``sim/scenarios.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Scripted regression scenarios: replays of previously-fixed races.

Each scenario drives the interleaving a past PR's hardening addressed and
checks the property that hardening restored — with the fix reverted the
scenario's extra check (or a standard invariant) fails; at HEAD they all
pass. Run from tests/test_sim_scenarios.py, or ad hoc:

    python -c "from modelmesh_tpu_torch.sim.scenarios import run_all; run_all()"

Catalog (race -> origin):
- fanout_budget_under_first_load_failure — the chained fan-out budget:
  a failed first load must shrink, never inflate, the copies the top-up
  pass places (total placements hard-capped at 1 + chain).
- promote_publish_suppression — the suppression cross-check: promote
  txns commit advertisements outside the publish io lock, so an
  interleave can leave KV older than _last_published; suppression must
  repair, not suppress forever.
- lease_expiry_republish — the close/keepalive lease races: expiry
  under a LIVE instance must re-establish + republish; a lease expiring
  while the instance is killed must NOT leak a resurrected ephemeral.
- delete_reregister_race — the watch-driven deletion-cleanup vs
  re-register converge rule: a re-registration landing mid-cleanup ends
  with a served copy, not a torn-down one.
- partition_through_janitor — janitor/reaper reconciliation across a KV
  blackout: skipped cycles (the _kv_reachable guard) must not leave
  permanent divergence after heal.
- mass_restart_jitter — the task-cadence jitter satellite: a fleet whose
  background tasks all start at t=0 must not fire its publisher ticks in
  lockstep.
- transfer_sender_killed_mid_stream / transfer_sender_partitioned_mid_stream
  — the transfer/ subsystem's fault contract: a weight stream whose
  SENDER crashes (or is partitioned) mid-transfer must fall back to a
  store load on the receiver, with the demanded-model-served invariant
  intact and no phantom registry state at quiescence.
- rolling_restart_under_zipf_load — the reconfig/ tentpole proof: a
  full-fleet rolling upgrade (drain waves of MM_UPGRADE_MAX_UNAVAILABLE,
  reconfig/rolling.py + drain.py) under seeded Zipf probe traffic, with
  ZERO request failures observed at any virtual instant and every
  demanded model served throughout.
- live_registry_migration_under_load — the fenced flat->bucketed
  registry migration (kv/migrate.py live mode) against a serving
  cluster: dual-read + move-on-write keep exactly one authoritative key
  per id, requests never fail, and the migration converges to DONE.
- late_eviction_deregister_quiesce — the registry_cache_convergence
  flake regression: a last-instant eviction whose async deregister is
  deterministically held until quiesce (SimKV write-hold gate) — the
  quiesce's async-drain + inline janitor cycle must repair the record
  before invariants read (fails with quiesce_async reverted, see
  tests/test_sim_scenarios.py meta-test).
- overload_shed_protects_slo — the admission-control tentpole proof:
  a lo-class flood under a virtual-time congestion service model
  overloads the fleet; with MM_ADMISSION on, sim-0's burn-rate-driven
  controller floor-throttles the lo class (typed OverloadShed failures
  in the request log — non-vacuity checked) and the judged hi-class
  probes hold p99<1200ms at every 10 s checkpoint; the admission-off
  variant breaches (meta-test, non-vacuity both ways).
- flash_crowd_autoscaled — the autoscale/ tentpole proof: a flash crowd
  on a single-copy hot model under PER-INSTANCE congestion pricing;
  with MM_AUTOSCALE=burn the leader's controller converts the hot
  class's burn rate into peer-streamed copy adds and the judged
  post-ramp probes hold p99<2500ms at every 10 s checkpoint, with the
  decisions flight-recorded; the legacy twin never reacts and breaches
  (meta-tests prove non-vacuity both ways; a deliberately violated
  judged spec fails WITH the controller's decisions visible in the
  attached flight-recorder dump).
- slo_under_flash_crowd — the observability tentpole proof: seeded Zipf
  probes (entered via rotating pods, forcing forward hops) with a
  flash-crowd overlay on a slow-loading cold model, judged by the
  machine-checked ``slo_attained`` invariant at every 10 s virtual
  checkpoint — PLUS assembled multi-instance trace-tree checks
  (route-select/forward/load-wait/peer-stream spans with virtual
  timestamps, cross-instance parent links). The parametrized spec makes
  the meta-test's violated variant fail the invariant and emit the
  flight-recorder dump (non-vacuity both ways).
- sharded_group_drain_zero_gap — the sharded-execution tentpole proof:
  a 12x-oversized model serves from a solver-planned 2-member placement
  group; one member drains mid-run (shard re-planned to the survivor —
  group-atomic, pre-copy before drop) with ZERO probe failures, p99
  within bound at every checkpoint, and group_complete_or_absent at
  quiescence.
"""

from __future__ import annotations

import random

from modelmesh_tpu_torch.records import InstanceRecord
from modelmesh_tpu_torch.serving.tasks import TaskConfig
from modelmesh_tpu_torch.sim.harness import SimCluster
from modelmesh_tpu_torch.sim.kv import SimKVConfig
from modelmesh_tpu_torch.sim.scenario import (
    Event,
    Scenario,
    ScenarioResult,
    run_scenario,
)

# Compressed cadences shared by the scripted scenarios (the randomized
# explorer uses its own): every protocol loop still runs, hours faster.
def _tasks() -> TaskConfig:
    return TaskConfig(
        publish_interval_s=8.0,
        rate_interval_s=4.0,
        janitor_interval_s=30.0,
        reaper_interval_s=30.0,
        assume_gone_ms=60_000,
    )


# ------------------------------------------------------------------ #
# 1. chained fan-out budget under first-load failure                  #
# ------------------------------------------------------------------ #

_CHAIN = 2


def _check_fanout_budget(cluster: SimCluster):
    inst = cluster.first_live().instance
    mr = inst.registry.get("m-chain")
    if mr is None:
        return ["m-chain lost its registration"]
    placements = sorted(mr.all_placements)
    # 1 original + _CHAIN chained copies is the hard ceiling; the failed
    # first load must shrink delivery, never bait the top-up past it.
    if len(placements) > 1 + _CHAIN:
        return [
            f"fan-out budget exceeded: {len(placements)} placements "
            f"{placements} for chain={_CHAIN}"
        ]
    return []


def fanout_budget_under_first_load_failure() -> Scenario:
    return Scenario(
        name="fanout-budget-first-load-failure",
        seed=101,
        n_instances=4,
        horizon_ms=30_000,
        task_config=_tasks(),
        events=[
            Event(0, "register", ("m-chain",)),
            # The first (local) load on sim-0 fails; the chain fan-out
            # already dispatched its directed placements at claim time.
            Event(200, "fail_load", ("sim-0", "m-chain")),
            Event(400, "slow_load", ("sim-1", "m-chain", 3_000)),
            Event(600, "ensure", ("m-chain", _CHAIN)),
        ],
        extra_checks={"fanout_budget": _check_fanout_budget},
    )


# ------------------------------------------------------------------ #
# 2. promote-txn / publish suppression interleaving                   #
# ------------------------------------------------------------------ #


def _check_advert_fresh(cluster: SimCluster):
    """The cluster-visible advertisement must converge to each live
    instance's real state — a suppression decision taken against a newer
    _last_published than what actually committed (the promote-txn
    interleave) would freeze a stale model_count here forever."""
    out = []
    for pod in cluster.live_pods():
        kv = cluster.kv.inner.get(pod.instance._session.key)
        if kv is None:
            out.append(f"{pod.iid}: no advertisement in the KV")
            continue
        seen = InstanceRecord.from_bytes(kv.value, kv.version)
        real = len(pod.instance.cache)
        if seen.model_count != real:
            out.append(
                f"{pod.iid}: advertised model_count {seen.model_count} "
                f"!= actual {real} (suppressed repair?)"
            )
    return out


def promote_publish_suppression() -> Scenario:
    # Load churn + delayed/reordered watches + amplified CAS conflicts:
    # the exact environment where promote-piggybacked publishes interleave
    # with standalone ones.
    events = [Event(0, "register", (f"m-pub-{i}",)) for i in range(6)]
    events += [
        Event(500 + 300 * i, "ensure", (f"m-pub-{i}",)) for i in range(6)
    ]
    events += [
        Event(4_000 + 700 * i, "invoke", (f"m-pub-{i % 6}",))
        for i in range(12)
    ]
    events += [Event(9_000, "unregister", ("m-pub-0",)),
               Event(9_050, "unregister", ("m-pub-1",))]
    return Scenario(
        name="promote-publish-suppression",
        seed=102,
        n_instances=3,
        horizon_ms=30_000,
        task_config=_tasks(),
        kv_config=SimKVConfig(
            latency_ms=1.0, latency_jitter_ms=10.0,
            cas_conflict_p=0.1, watch_delay_ms=40.0, watch_reorder_p=0.3,
        ),
        events=events,
        extra_checks={"advert_fresh": _check_advert_fresh},
    )


# ------------------------------------------------------------------ #
# 3. lease expiry: republish for the living, silence for the dead     #
# ------------------------------------------------------------------ #


def _check_session_records(cluster: SimCluster):
    out = []
    for pod in cluster.pods:
        kv = cluster.kv.inner.get(pod.instance._session.key)
        if pod.alive and kv is None:
            out.append(
                f"{pod.iid}: live instance's ephemeral advertisement "
                "was not re-established after lease expiry"
            )
        if not pod.alive and kv is not None:
            out.append(
                f"{pod.iid}: dead instance's ephemeral resurrected "
                "(a post-close keepalive/establish leaked a lease)"
            )
    return out


def lease_expiry_republish() -> Scenario:
    return Scenario(
        name="lease-expiry-republish",
        seed=103,
        n_instances=3,
        horizon_ms=40_000,
        task_config=_tasks(),
        events=[
            Event(0, "register", ("m-lease",)),
            Event(300, "ensure", ("m-lease",)),
            # Expire the lease under a healthy instance — twice, across
            # keepalive cycles: each must re-establish and republish.
            Event(5_000, "expire_lease", ("sim-1",)),
            Event(15_000, "expire_lease", ("sim-1",)),
            # Race an expiry against a crash: the close path must win —
            # no re-established ephemeral for a dead instance.
            Event(20_000, "expire_lease", ("sim-2",)),
            Event(20_000, "kill", ("sim-2",)),
        ],
        extra_checks={"session_records": _check_session_records},
    )


# ------------------------------------------------------------------ #
# 4. registry delete / re-register race through watch cleanup         #
# ------------------------------------------------------------------ #


def _check_reregistered_served(cluster: SimCluster):
    inst = cluster.first_live().instance
    mr = inst.registry.get("m-flap")
    if mr is None:
        return ["m-flap: final re-registration lost"]
    return []  # served-ness is demanded_models_served's job


def delete_reregister_race() -> Scenario:
    # Rapid unregister/register flaps under delayed watches: the
    # watch-driven deletion cleanup races each re-registration; the
    # converge rule (re-read + re-place after removal) must win.
    # Flap events are spaced several runner steps apart: each fires on
    # its own worker thread, and the unregister must have COMMITTED
    # before the re-register lands — the race under test is cleanup-vs-
    # re-register through the delayed watch, not thread-spawn order.
    events = [
        Event(0, "register", ("m-flap",)),
        Event(300, "ensure", ("m-flap",)),
    ]
    t = 5_000
    for _ in range(3):
        events.append(Event(t, "unregister", ("m-flap",)))
        events.append(Event(t + 1_500, "register", ("m-flap",)))
        events.append(Event(t + 3_000, "ensure", ("m-flap",)))
        t += 6_000
    return Scenario(
        name="delete-reregister-race",
        seed=104,
        n_instances=3,
        horizon_ms=30_000,
        task_config=_tasks(),
        kv_config=SimKVConfig(watch_delay_ms=60.0, watch_reorder_p=0.25),
        events=events,
        extra_checks={"reregistered": _check_reregistered_served},
        step_ms=500,
    )


# ------------------------------------------------------------------ #
# 5. partition across janitor/reaper cycles                           #
# ------------------------------------------------------------------ #


def _check_partitioned_readvertised(cluster: SimCluster):
    pod = cluster.by_id("sim-1")
    kv = cluster.kv.inner.get(pod.instance._session.key)
    if kv is None:
        return ["sim-1: advertisement not restored after heal"]
    return []


def partition_through_janitor() -> Scenario:
    return Scenario(
        name="partition-through-janitor",
        seed=105,
        n_instances=3,
        horizon_ms=120_000,
        task_config=_tasks(),
        events=[
            Event(0, "register", ("m-part-a",)),
            Event(200, "register", ("m-part-b",)),
            Event(500, "ensure", ("m-part-a",)),
            Event(700, "ensure", ("m-part-b",)),
            # Blackout sim-1 for ~3 janitor cycles; its lease expires,
            # peers see it vanish, the janitor guard skips its cycles.
            Event(10_000, "partition", ("sim-1",)),
            Event(30_000, "invoke", ("m-part-a",)),
            Event(100_000, "heal", ("sim-1",)),
        ],
        extra_checks={"readvertised": _check_partitioned_readvertised},
    )


# ------------------------------------------------------------------ #
# 6. mass-restart cadence jitter                                      #
# ------------------------------------------------------------------ #

def _check_jitter_spread(cluster: SimCluster):
    """OBSERVED first publisher ticks (BackgroundTasks.tick_times, virtual
    ms) must spread across the fleet. With the jitter reverted, every
    task waits exactly the interval from the same start instant — all
    first ticks collapse onto one timestamp (modulo the runner's step
    grid, which is why the scenario runs at a fine step)."""
    firsts = []
    for pod in cluster.pods:
        ticks = pod.tasks.tick_times.get("publisher")
        if not ticks:
            return [f"{pod.iid}: publisher never ticked"]
        firsts.append(ticks[0])
    distinct = len(set(firsts))
    if distinct < max(2, len(firsts) - 1):
        return [
            f"publisher first ticks collapse onto {distinct} instant(s): "
            f"{sorted(firsts)} — thundering herd on mass restart"
        ]
    return []


def mass_restart_jitter() -> Scenario:
    return Scenario(
        name="mass-restart-jitter",
        seed=106,
        n_instances=4,
        horizon_ms=20_000,
        task_config=_tasks(),
        events=[
            Event(0, "register", ("m-jit",)),
            Event(300, "ensure", ("m-jit",)),
        ],
        extra_checks={"jitter_spread": _check_jitter_spread},
        # Fine step: first-tick timestamps quantize onto the runner grid,
        # and the whole point is telling a ~U[0,8s) spread from lockstep.
        step_ms=200,
    )


# ------------------------------------------------------------------ #
# 7./8. weight-transfer sender dies / is partitioned mid-stream        #
# ------------------------------------------------------------------ #


def _check_fault_fired(model_id: str, action: str):
    """Non-vacuity guard: the armed mid-stream fault must actually have
    FIRED (a transfer was in flight and crossed the chunk threshold) —
    otherwise the scenario silently stopped exercising the stream path
    and the fallback check proves nothing."""

    def check(cluster: SimCluster):
        fired = [
            (m, a) for m, a, _ in cluster.transfer_faults_fired
            if m == model_id and a == action
        ]
        if not fired:
            return [
                f"armed {action} fault for {model_id} never fired — no "
                "peer stream reached the chunk threshold (vacuous run)"
            ]
        return []

    return check


def _check_transfer_fallback(model_id: str, expect_live: tuple[str, ...]):
    """The receiver must end with a servable copy materialized from the
    STORE after the peer stream broke — and the broken transfer must not
    leave phantom registry state (a partial promotion that never
    finalized, or a host claim on the dead/partitioned sender that has
    no snapshot behind it is caught by the standard invariants)."""

    def check(cluster: SimCluster):
        out = []
        from modelmesh_tpu_torch.serving.entry import EntryState

        servable = []
        for pod in cluster.live_pods():
            ce = pod.instance.cache.get_quietly(model_id)
            if ce is not None and ce.state.is_servable:
                servable.append(pod.iid)
        if not any(iid in servable for iid in expect_live):
            out.append(
                f"{model_id}: no servable copy on the surviving receivers "
                f"(servable on {servable}; expected among {expect_live})"
            )
        # The receiver's store fallback must have actually materialized
        # the runtime copy, not just flipped entry state.
        for iid in servable:
            pod = cluster.by_id(iid)
            if not pod.loader.is_loaded(model_id):
                out.append(
                    f"{model_id}: {iid} advertises a copy its runtime "
                    "does not hold"
                )
        return out

    return check


def transfer_sender_killed_mid_stream() -> Scenario:
    """Flash-style second copy streams from the only holder; the holder
    is CRASHED after 3 chunks. The receiver must fall back to a store
    load with no demanded-model-unserved violation at quiescence."""
    return Scenario(
        name="transfer-sender-killed-mid-stream",
        seed=107,
        n_instances=3,
        horizon_ms=40_000,
        task_config=_tasks(),
        events=[
            Event(0, "register", ("m-xfer",)),
            # First copy loads on sim-0 (store, 50ms virtual).
            Event(200, "ensure", ("m-xfer",)),
            # Arm: once sim-0 has served 3 chunks of m-xfer, kill it.
            Event(3_000, "transfer_fault", ("m-xfer", 3, "kill")),
            # Second copy: the receiver resolves sim-0 as its source,
            # streams 3 chunks, then the sender dies mid-stream.
            Event(3_500, "ensure", ("m-xfer", 1)),
            # Demand keeps flowing after the fault: the fallback copy
            # must actually serve.
            Event(20_000, "invoke", ("m-xfer",)),
        ],
        extra_checks={
            "transfer_fallback": _check_transfer_fallback(
                "m-xfer", ("sim-1", "sim-2")
            ),
            "fault_fired": _check_fault_fired("m-xfer", "kill"),
        },
    )


def transfer_sender_partitioned_mid_stream() -> Scenario:
    """Same shape, but the sender is network-PARTITIONED (transfer
    channel unreachable, lease eventually expires) and later heals —
    receiver falls back to the store; after heal the cluster must
    reconverge with no invariant violation."""
    return Scenario(
        name="transfer-sender-partitioned-mid-stream",
        seed=108,
        n_instances=3,
        horizon_ms=60_000,
        task_config=_tasks(),
        events=[
            Event(0, "register", ("m-part-x",)),
            Event(200, "ensure", ("m-part-x",)),
            Event(3_000, "transfer_fault", ("m-part-x", 3, "partition")),
            Event(3_500, "ensure", ("m-part-x", 1)),
            Event(25_000, "invoke", ("m-part-x",)),
            Event(45_000, "heal", ("sim-0",)),
        ],
        extra_checks={
            "transfer_fallback": _check_transfer_fallback(
                "m-part-x", ("sim-1", "sim-2")
            ),
            "fault_fired": _check_fault_fired("m-part-x", "partition"),
        },
    )


# ------------------------------------------------------------------ #
# 9. full-fleet rolling restart under Zipf load (reconfig/ tentpole)   #
# ------------------------------------------------------------------ #

_ZIPF_MODELS = [f"m-z{i}" for i in range(6)]
_TARGET_VERSION = "v2"
_WAVE_WIDTH = 2


def _zipf_invokes(seed: int, start_ms: int, end_ms: int,
                  every_ms: int) -> list[Event]:
    """Seeded Zipf-popularity probe traffic: the event schedule derives
    only from the seed, so the scenario replays bit-for-bit."""
    rng = random.Random(seed)
    weights = [1.0 / (i + 1) ** 1.2 for i in range(len(_ZIPF_MODELS))]
    events = []
    for t in range(start_ms, end_ms, every_ms):
        mid = rng.choices(_ZIPF_MODELS, weights)[0]
        events.append(Event(t, "invoke", (mid,)))
    return events


def _check_no_request_failures(cluster: SimCluster):
    """The headline reconfiguration property: across the WHOLE run — every
    wave of the rolling restart included — no probe request failed. The
    observed request log is the 'at every virtual instant' witness."""
    failures = [
        f"@{t}ms {mid}: {err}"
        for t, mid, ok, err, _lat in cluster.request_log if not ok
    ]
    if failures:
        return [
            f"{len(failures)} request failure(s) during the run: "
            + "; ".join(failures[:5])
        ]
    if not cluster.request_log:
        return ["no probe requests observed (vacuous run)"]
    return []


def _check_fleet_upgraded(cluster: SimCluster):
    out = []
    report = cluster.upgrade_report
    if report is None:
        return ["rolling upgrade never ran"]
    if report.failures:
        out.append(f"upgrade reported failures: {report.failures}")
    if any(len(w) > _WAVE_WIDTH for w in report.waves):
        out.append(
            f"wave width exceeded max_unavailable={_WAVE_WIDTH}: "
            f"{report.waves}"
        )
    live = cluster.live_pods()
    stale = [
        p.iid for p in live
        if p.instance.config.instance_version != _TARGET_VERSION
    ]
    if stale:
        out.append(f"instances still down-version at quiescence: {stale}")
    # Non-vacuity: the drained pods really handed copies off (a fleet
    # that never held the demanded models would pass everything else).
    migrated = sum(
        len(r.migrated) for r in cluster.drain_reports.values()
        if r is not None
    )
    if migrated == 0:
        out.append("no model was migrated by any drain (vacuous upgrade)")
    return out


def rolling_restart_under_zipf_load() -> Scenario:
    """Every instance of a 4-pod fleet is drained, killed, and replaced
    at a new version in waves of 2 (MM_UPGRADE_MAX_UNAVAILABLE), while
    seeded Zipf traffic keeps probing all demanded models. Invariants:
    zero request failures at any virtual instant, every demanded model
    served, the whole fleet up-version at quiescence."""
    events = [
        Event(0, "register", (mid,)) for mid in _ZIPF_MODELS
    ]
    # Two copies of the hottest models, one of the tail — the drain must
    # handle both sole-copy handoff and already-redundant models.
    events += [
        Event(400 + 150 * i, "ensure", (mid, 1 if i < 2 else 0))
        for i, mid in enumerate(_ZIPF_MODELS)
    ]
    events += _zipf_invokes(seed=109, start_ms=2_000, end_ms=56_000,
                            every_ms=700)
    # Waves start after the initial loads are settled and run while the
    # probe traffic keeps flowing.
    events.append(
        Event(12_000, "rolling_upgrade", (_TARGET_VERSION, _WAVE_WIDTH))
    )
    return Scenario(
        name="rolling-restart-under-zipf-load",
        seed=109,
        n_instances=4,
        horizon_ms=60_000,
        task_config=_tasks(),
        instance_kwargs={"instance_version": "v1"},
        events=events,
        extra_checks={
            "no_request_failures": _check_no_request_failures,
            "fleet_upgraded": _check_fleet_upgraded,
        },
    )


# ------------------------------------------------------------------ #
# 10. live registry migration under load                               #
# ------------------------------------------------------------------ #

_FLAT_MODELS = [f"m-f{i}" for i in range(4)]


def _check_single_authoritative_key(cluster: SimCluster):
    """No CAS split-brain: at quiescence every model id owns exactly one
    registry key, and no flat-layout key survives (the migration
    converged)."""
    out = []
    inner = cluster.kv.inner
    by_id: dict[str, list[str]] = {}
    for kv in inner.range("mm/registry/"):
        rest = kv.key[len("mm/registry/"):]
        id_ = rest.partition("/")[2] or rest
        by_id.setdefault(id_, []).append(kv.key)
        if "/" not in rest:
            out.append(f"flat key survived the migration: {kv.key}")
    for id_, keys in sorted(by_id.items()):
        if len(keys) > 1:
            out.append(f"{id_} has {len(keys)} authoritative keys: {keys}")
    return out


def _check_migration_done(cluster: SimCluster):
    from modelmesh_tpu_torch.kv import migrate as _migrate

    kv = cluster.kv.inner.get(_migrate.migration_fence_key("mm"))
    if kv is None:
        return ["migration fence never advertised"]
    import json

    phase = json.loads(kv.value.decode()).get("phase")
    if phase != _migrate.PHASE_DONE:
        return [f"migration did not reach DONE (phase={phase})"]
    # Non-vacuity: m-f3 is never demanded, so no writer ever touched it —
    # only the MIGRATOR can have moved it to its bucketed key.
    if cluster.kv.inner.get("mm/registry/m-f3") is not None:
        return ["m-f3 still flat — the migrator's sweep never moved it"]
    if cluster.first_live().instance.registry.get("m-f3") is None:
        return ["m-f3 lost during migration (neither flat nor bucketed)"]
    return []


def live_registry_migration_under_load() -> Scenario:
    """A registry seeded with LEGACY flat-layout keys serves traffic
    while the fenced live migration runs: the epoch fence turns on
    dual-read + move-on-write, writers move the records they touch, the
    migrator sweeps the cold remainder, and the fence advances to DONE —
    with zero request failures and exactly one authoritative key per id
    at quiescence. m-f3 is never demanded (the migrator, not a writer,
    must move it); m-f2 is unregistered mid-migration (both key forms
    must die)."""
    events = [
        Event(0, "register_flat", (mid,)) for mid in _FLAT_MODELS
    ]
    # Operator advertises the epoch BEFORE any move; instances' fence
    # watches flip them to dual-read within watch latency.
    events.append(Event(300, "migrate_fence", ("live",)))
    events += [
        Event(2_000 + 400 * i, "ensure", (mid,))
        for i, mid in enumerate(_FLAT_MODELS[:3])
    ]
    events += [
        Event(5_000 + 900 * i, "invoke", (_FLAT_MODELS[i % 3],))
        for i in range(12)
    ]
    # A normally-registered model rides along: mixed old/new-layout
    # traffic through one serving registry.
    events.append(Event(6_500, "register", ("m-new",)))
    events.append(Event(7_000, "ensure", ("m-new",)))
    events.append(Event(16_000, "migrate_live", ()))
    events.append(Event(18_000, "unregister", ("m-f2",)))
    events += [
        Event(24_000 + 900 * i, "invoke", (_FLAT_MODELS[i % 2],))
        for i in range(6)
    ]
    return Scenario(
        name="live-registry-migration-under-load",
        seed=110,
        n_instances=3,
        horizon_ms=45_000,
        task_config=_tasks(),
        events=events,
        extra_checks={
            "no_request_failures": _check_no_request_failures,
            "single_authoritative_key": _check_single_authoritative_key,
            "migration_done": _check_migration_done,
        },
    )


# ------------------------------------------------------------------ #
# 11. late eviction's async deregister vs the quiesce (flake fix)      #
# ------------------------------------------------------------------ #


def _check_evicted(cluster: SimCluster):
    """Non-vacuity: the squeeze really evicted sim-0's copy (otherwise
    the convergence check proves nothing)."""
    ce = cluster.by_id("sim-0").instance.cache.get_quietly("m-ev")
    if ce is not None:
        return ["squeeze did not evict m-ev from sim-0 (vacuous run)"]
    return []


def late_eviction_deregister_quiesce() -> Scenario:
    """Replays the CHANGES.md PR-6 flake deterministically: a capacity
    squeeze at the last virtual instant evicts a copy whose async
    deregister is HELD (SimKV write gate) — modeling the CAS landing
    after the final scheduled janitor cycle. The quiesce must release
    the gate, drain the pending deregisters, and run one extra janitor
    pass before invariants read; with that reverted
    (Scenario.quiesce_async=False) registry_cache_convergence fails."""
    return Scenario(
        name="late-eviction-deregister-quiesce",
        seed=111,
        n_instances=3,
        horizon_ms=10_000,
        task_config=_tasks(),
        events=[
            Event(0, "register", ("m-ev",)),
            # Two copies: the eviction on sim-0 must not leave the model
            # unserved (that is demanded_models_served's concern; this
            # scenario isolates the registry-record staleness).
            Event(300, "ensure", ("m-ev", 1)),
            # Gate sim-0's registry writes, THEN squeeze its cache to
            # nothing: the eviction fires, its deregister CAS blocks.
            Event(8_000, "hold_kv_writes", ("sim-0", "registry/")),
            Event(9_000, "squeeze", ("sim-0", "1")),
        ],
        extra_checks={"evicted": _check_evicted},
    )


# ------------------------------------------------------------------ #
# 12. SLO attainment + assembled trace trees under Zipf + flash crowd  #
# ------------------------------------------------------------------ #

_SLO_MODELS = [f"m-s{i}" for i in range(6)]
# SLOW_LOAD_PREFIX forces a >=2s virtual load on every pod — the flash
# crowd rides ONE load and its virtual latency is deterministic-ish.
_FLASH_MODEL = "slow-load-flash"


def _slo_zipf_invokes(seed: int, start_ms: int, end_ms: int,
                      every_ms: int, n_pods: int) -> list[Event]:
    """Seeded Zipf probes entered via a ROTATING pod: with fewer copies
    than pods, some entries are guaranteed non-holders, so forward hops
    (and their trace handoffs) happen deterministically."""
    rng = random.Random(seed)
    weights = [1.0 / (i + 1) ** 1.2 for i in range(len(_SLO_MODELS))]
    events = []
    for k, t in enumerate(range(start_ms, end_ms, every_ms)):
        mid = rng.choices(_SLO_MODELS, weights)[0]
        events.append(Event(t, "invoke", (mid, f"sim-{k % n_pods}")))
    return events


def _check_trace_trees(cluster: SimCluster):
    """The tentpole's observable: assembled MULTI-INSTANCE trace trees.

    (a) some trace crosses instances through a forward hop and ends in a
        runtime call, with the forwarded hop's record parented under the
        sender's forward span (the cross-instance tree edge);
    (b) the flash crowd leaves one trace showing route-select +
        load-wait riding the shared load;
    (c) some trace shows a peer weight stream with the SENDER's
        serve-chunk records joined in (receiver + sender instances);
    (d) every span timestamp is VIRTUAL (>= the virtual epoch) — the
        satellite clock fix made observable.
    """
    from modelmesh_tpu_torch.sim.tracing import TraceCollector
    from modelmesh_tpu_torch.utils.clock import VIRTUAL_EPOCH_MS

    col = TraceCollector(cluster)
    traces = col.collect()
    out: list[str] = []
    if not traces:
        return ["no traces collected (vacuous run)"]

    def names(recs):
        got = set()
        for r in recs:
            for s in r["spans"]:
                got.add(s["name"])
        return got

    def insts(recs):
        return {r["instance"] for r in recs}

    fwd_trace = None
    for tid, recs in traces.items():
        if len(insts(recs)) >= 2 and {"forward", "runtime-call"} <= names(recs):
            fwd_trace = tid
            break
    if fwd_trace is None:
        out.append("no multi-instance trace with forward + runtime-call")
    else:
        # The cross-instance edge: a record whose parent is the sending
        # side's forward span.
        recs = traces[fwd_trace]
        span_ids = {
            s["span_id"] for r in recs for s in r["spans"]
            if s["name"] == "forward"
        }
        if not any(r["parent_id"] in span_ids for r in recs):
            out.append(
                f"trace {fwd_trace}: forwarded record not parented "
                "under the sender's forward span"
            )
        elif col.depth(fwd_trace) < 3:
            out.append(
                f"trace {fwd_trace}: assembled tree depth "
                f"{col.depth(fwd_trace)} < 3"
            )
    if not any(
        {"route-select", "load-wait"} <= names(recs)
        for recs in traces.values()
    ):
        out.append("no trace shows route-select + load-wait (flash crowd)")
    if not any(
        "peer-stream" in names(recs) and len(insts(recs)) >= 2
        and "serve-chunk" in names(recs)
        for recs in traces.values()
    ):
        out.append(
            "no multi-instance peer-stream trace with sender serve-chunk"
        )
    for tid, recs in traces.items():
        for r in recs:
            stamps = [r["start_ms"]] + [s["start_ms"] for s in r["spans"]]
            if any(ts < VIRTUAL_EPOCH_MS for ts in stamps):
                out.append(
                    f"trace {tid}: wall-clock timestamp leaked into a "
                    "virtual-time trace"
                )
                break
    return out


def slo_under_flash_crowd(p99_ms: float = 8_000.0) -> Scenario:
    """Seeded Zipf load with a flash-crowd overlay, judged by the
    machine-checked SLO invariant at every 10 s virtual checkpoint, plus
    the assembled-trace-tree checks. ``p99_ms`` parametrizes the spec so
    the meta-test can prove non-vacuity: a deliberately violated spec
    (e.g. p99<100ms against a flash crowd riding a 2 s load) must FAIL
    the invariant and emit a flight-recorder dump."""
    from modelmesh_tpu_torch.sim import invariants

    n_pods = 4
    events = [Event(0, "register", (mid,)) for mid in _SLO_MODELS]
    events.append(Event(0, "register", (_FLASH_MODEL,)))
    # Two copies of the two hottest, singles for the tail: 8 copies over
    # 4 pods leaves every pod a non-holder of SOMETHING hot.
    events += [
        Event(400 + 150 * i, "ensure", (mid, 1 if i < 2 else 0))
        for i, mid in enumerate(_SLO_MODELS)
    ]
    events += _slo_zipf_invokes(
        seed=112, start_ms=4_000, end_ms=54_000, every_ms=600,
        n_pods=n_pods,
    )
    # Flash crowd: a cold model with a forced >=2s load, hammered from
    # every pod — one store load, everyone else rides it (load-wait) or
    # forwards to the loading copy.
    events += [
        Event(20_000 + 300 * k, "invoke", (_FLASH_MODEL, f"sim-{k % n_pods}"))
        for k in range(10)
    ]
    # Scale-up after the crowd: the second copy streams weights from the
    # first over the mesh transfer channel (peer-stream + serve-chunk).
    events.append(Event(30_000, "ensure", (_FLASH_MODEL, 1)))
    spec = f"default:p99<{p99_ms:g}ms,availability>0.999"
    return Scenario(
        name="slo-under-flash-crowd",
        seed=112,
        n_instances=n_pods,
        horizon_ms=60_000,
        task_config=_tasks(),
        events=events,
        step_ms=500,
        extra_checks={
            "slo_attained": invariants.slo_attained(
                spec, window_ms=10_000, min_requests=3
            ),
            "no_request_failures": _check_no_request_failures,
            "trace_trees": _check_trace_trees,
        },
    )


# ------------------------------------------------------------------ #
# 13. overload: burn-rate admission shedding protects the top class    #
# ------------------------------------------------------------------ #

# The pods' SLO spec IS the admission priority order: 'hi' (first
# clause) is never shed; 'lo'-typed traffic resolves to 'default' and
# gets throttled when 'hi' burns budget. Bounds live on the runner's
# 500 ms step grid (a virtual sleep completes at the next advance, so
# every observed latency is a step multiple): 1200 ms admits up to two
# quantized steps (a judged hi probe overlapping a couple of floored lo
# dispatches) and rejects three or more — which under the flood's
# compounding backlog is where every unthrottled request lands.
_OVERLOAD_SPEC = "hi:p99<1200ms;default:p99<30000ms"
_LO_MODELS = [f"lo-{i}" for i in range(4)]
# Judged vs warmup hi traffic: admission control REACTS to breach, so
# the detection ramp (hi-warm breaching while the burn signal
# accumulates) is driven by a sibling model of the same class and only
# the post-ramp hi-0 probes are judged — the property under test is
# "the protected class HOLDS once the controller engages", not "no
# breach ever" (no reactive controller can promise that).
_HI_JUDGED = "hi-0"
_HI_WARM = "hi-warm"


def _check_hi_never_failed(cluster: SimCluster):
    """The protected class is never shed and never fails — its priority
    index is 0, which the admission controller exempts by construction."""
    bad = [
        f"@{t}ms {mid}: {err}"
        for t, mid, ok, err, _lat in cluster.request_log
        if not ok and mid in (_HI_JUDGED, _HI_WARM)
    ]
    if bad:
        return [f"hi-class failures: {'; '.join(bad[:5])}"]
    return []


def _check_sheds_fired(cluster: SimCluster):
    """Non-vacuity (admission ON): the overload really tripped the
    controller — some lo-class probes were shed with the typed error."""
    sheds = [
        1 for _t, mid, ok, err, _lat in cluster.request_log
        if not ok and mid.startswith("lo-") and "OverloadShed" in err
    ]
    if not sheds:
        return [
            "no lo-class request was shed — admission never engaged "
            "(vacuous overload run)"
        ]
    return []


def overload_shed_protects_slo(admission: bool = True) -> Scenario:
    """Deliberate overload under a virtual-time congestion service
    model (each runtime dispatch costs 5 + 300*(concurrent-1) ms —
    deliberately fleet-global: the scenario tests admission, not
    placement). A sustained lo-class flood drives latency far past the
    hi class's p99<1200ms objective; with MM_ADMISSION on, sim-0's
    controller reads the hi burn rate, floor-throttles the default
    class, and the judged hi probes HOLD their SLO at every 10 s
    checkpoint; with it off the same traffic breaches (the meta-test in
    tests/test_sim_scenarios.py proves non-vacuity both ways, and the
    passing variant is replay-pinned bit-for-bit)."""
    from modelmesh_tpu_torch.sim import invariants

    events = [
        Event(0, "register", (_HI_JUDGED, "hi")),
        Event(0, "register", (_HI_WARM, "hi")),
    ]
    events += [Event(0, "register", (mid, "lo")) for mid in _LO_MODELS]
    events += [
        Event(400 + 150 * i, "ensure", (mid,))
        for i, mid in enumerate([_HI_JUDGED, _HI_WARM] + _LO_MODELS)
    ]
    # The flood: lo-class probes arriving ~5 per runner step; with each
    # dispatch costing 300*(concurrent-1) ms and requests spanning
    # steps, the unthrottled backlog compounds into multi-second
    # latencies — genuine overload, not a fixed delay.
    events += [
        Event(t, "invoke", (_LO_MODELS[(t // 80) % len(_LO_MODELS)],))
        for t in range(4_000, 54_000, 80)
    ]
    # Burn-detection ramp: hi-warm probes breach while the window
    # accumulates evidence (unjudged).
    events += [
        Event(t, "invoke", (_HI_WARM,)) for t in range(4_000, 20_000, 300)
    ]
    # Judged hi probes: by 20 s the controller (refresh cadence 250 ms,
    # MIN_BURN_SAMPLES reached within seconds of the ramp) has floored
    # the lo class — these must meet p99<1200ms at every checkpoint.
    events += [
        Event(t, "invoke", (_HI_JUDGED,))
        for t in range(20_000, 54_000, 1_000)
    ]
    checks = {
        "hi_slo_attained": invariants.slo_attained(
            _OVERLOAD_SPEC, window_ms=10_000, min_requests=3,
            model_filter=lambda m: m == _HI_JUDGED, slo_class="hi",
        ),
        "hi_never_failed": _check_hi_never_failed,
    }
    if admission:
        checks["sheds_fired"] = _check_sheds_fired
    return Scenario(
        name="overload-shed-protects-slo"
        + ("" if admission else "-admission-off"),
        seed=113,
        n_instances=3,
        horizon_ms=56_000,
        task_config=_tasks(),
        step_ms=500,
        # base > 0 is load-bearing: every dispatch must BLOCK (wake at
        # the next virtual advance) or workers serialize through a
        # zero-cost runtime and concurrency — hence congestion — never
        # accumulates at all.
        service_base_ms=5.0,
        service_congestion_ms=300.0,
        instance_kwargs={
            "slo_spec": _OVERLOAD_SPEC,
            "admission": admission,
            "admission_queue_ms": 20,
        },
        events=events,
        extra_checks=checks,
    )


# ------------------------------------------------------------------ #
# 14. flash crowd: burn-driven autoscaling closes the loop             #
# ------------------------------------------------------------------ #

# The hot model's class objective IS the controller's signal source:
# crowd latencies past 1200ms burn the hot class's budget, sim-0's
# (leader's) controller reads the burn and adds copies over the fast
# weight paths. Judged bounds live on the runner's 500ms step grid,
# like the overload scenario: a served-locally probe costs one step,
# the unthrottled single-holder backlog costs many.
_AS_SPEC = "hot:p99<1200ms;default:p99<30000ms"
_AS_MODEL = "as-hot"
# Detection-ramp allowance (judge_after_ms): a reactive controller
# cannot promise no-breach while its burn window is still accumulating
# evidence — the judged property is "the SLO holds once the controller
# has had its detection window" (PR-14 house style, pinned explicitly).
_AS_RAMP_MS = 20_000


def _check_autoscale_engaged(cluster: SimCluster):
    """Non-vacuity (autoscaler ON): the controller really closed the
    loop — burn-driven copy adds were DECIDED (flight-recorded on the
    leader), the adds LANDED (the hot model holds >= 2 copies at
    quiescence; the default 7-min surplus anti-thrash keeps them there
    through the quiesce), and the new copies rode the fast weight path
    (>= 1 streamed load: peer stream or host re-warm, never N store
    loads)."""
    out: list[str] = []
    decisions = [
        e for pod in cluster.pods
        for e in pod.instance.flightrec.dump()
        if e["kind"] == "autoscale-up"
    ]
    if not decisions:
        out.append(
            "no autoscale-up decision recorded — the controller never "
            "engaged (vacuous autoscale run)"
        )
    mr = cluster.first_live().instance.registry.get(_AS_MODEL)
    copies = len(mr.instance_ids) if mr is not None else 0
    if copies < 2:
        out.append(
            f"{_AS_MODEL} holds {copies} cop(ies) at quiescence — the "
            "burn-driven adds never landed"
        )
    streamed = sum(p.loader.stream_load_count for p in cluster.pods)
    if streamed < 1:
        out.append(
            "no scale-up copy was materialized over the stream path "
            "(peer fetch / host re-warm) — the flash crowd paid store "
            "loads"
        )
    return out


def flash_crowd_autoscaled(
    mode: str = "burn", p99_ms: float = 2500.0,
) -> Scenario:
    """A sustained flash crowd on a single-copy hot model, under a
    PER-INSTANCE congestion service model (each pod's dispatches price
    independently, so copy count and spread change latency). With
    MM_AUTOSCALE=burn the leader's controller reads the hot class's
    burn rate, doubles the copy count over the peer-stream path before
    the window p99 breaches, d-choices routing spreads the crowd over
    the new copies, and the judged post-ramp probes hold p99<2500ms at
    every 10 s checkpoint (5 runner steps: a locally-served probe costs
    one, a same-step neighbor on the same pod a couple, and a CPU-starved
    worker thread's virtual-latency inflation at most a couple more —
    while the unscaled twin's holder saturates at the congestion cap,
    4000ms, three full steps past the bound). The ``legacy`` twin never reacts (the crowd
    sits far below the 2000-rpm rate-task threshold — exactly the gap
    this controller closes) and breaches; the meta-tests in
    tests/test_sim_scenarios.py prove non-vacuity both ways, and a
    deliberately violated judged spec (``p99_ms=100``) fails with the
    controller's decisions visible in the attached flight-recorder
    dump. ``p99_ms`` parametrizes only the JUDGED spec — the pods'
    serving spec (the controller's signal) is fixed."""
    from modelmesh_tpu_torch.autoscale.controller import AutoscaleConfig
    from modelmesh_tpu_torch.sim import invariants

    n_pods = 4
    task_config = TaskConfig(
        publish_interval_s=8.0,
        rate_interval_s=4.0,
        janitor_interval_s=30.0,
        reaper_interval_s=30.0,
        assume_gone_ms=60_000,
        autoscale_mode=mode,
        autoscale_interval_s=2.0,
        autoscale=AutoscaleConfig(min_burn_samples=4, holddown_ms=4_000),
    )
    events = [
        Event(0, "register", (_AS_MODEL, "hot")),
        Event(400, "ensure", (_AS_MODEL,)),
    ]
    # The crowd: BURSTS of 4 simultaneous probes every 400ms from 6s
    # through 55.6s (10/s), one per entry pod. The burst shape is
    # load-bearing for determinism: 4 same-instant arrivals all
    # dispatch against the single holder before any can wake (their
    # sleeps end at the next runner advance), so its concurrency — and
    # the breach — does not depend on real-thread interleavings; once a
    # copy serves on every pod, each burst member is served locally at
    # concurrency ~1. The 125-burst length exactly fills the LAST
    # judged 10s window (judged traffic starts at 26s; 46-56s gets the
    # full 100 samples) — a sparse final window would make its
    # nearest-rank p99 the max of a handful of samples, with zero
    # tolerance for one scheduler-starved straggler.
    events += [
        Event(6_000 + 400 * j, "invoke", (_AS_MODEL, f"sim-{i}"))
        for j in range(125)
        for i in range(n_pods)
    ]
    judged_spec = f"hot:p99<{p99_ms:g}ms;default:p99<30000ms"
    checks = {
        "slo_attained": invariants.slo_attained(
            judged_spec, window_ms=10_000, min_requests=3,
            model_filter=lambda m: m == _AS_MODEL, slo_class="hot",
            judge_after_ms=_AS_RAMP_MS,
        ),
        "no_request_failures": _check_no_request_failures,
    }
    if mode == "burn":
        checks["autoscale_engaged"] = _check_autoscale_engaged
    return Scenario(
        name="flash-crowd-autoscaled"
        + ("" if mode == "burn" else f"-{mode}")
        + ("" if p99_ms == 2500.0 else "-tight"),
        seed=114,
        n_instances=n_pods,
        horizon_ms=60_000,
        task_config=task_config,
        step_ms=500,
        # Per-INSTANCE congestion pricing: more copies = fewer
        # concurrent dispatches per pod = lower tail. base > 0 is
        # load-bearing for the same reason as the overload scenario.
        service_base_ms=5.0,
        service_congestion_ms=300.0,
        service_scope="instance",
        # Bounded admission queue: the overloaded holder saturates at
        # 5 + 300*12 ≈ 3.6s per dispatch — quantized to 4000ms on the
        # step grid, 3 full steps PAST the judged 2500ms bound (the cap
        # must not saturate AT the bound: nearest-rank p99 of a
        # saturated window would then sit exactly on it and the
        # unscaled twin would pass on a quiet machine) — instead of
        # pricing an ever-deeper backlog, so once copies land and the
        # crowd spreads, the holder's leftover sleepers all wake within
        # ~3.6s and recovery is observable well before the judged
        # windows.
        service_congestion_cap=12,
        instance_kwargs={
            "slo_spec": _AS_SPEC,
            # Burn judged over a 10s window so the signal decays once
            # the spread absorbs the crowd (the default 60s window
            # would pin burn high for the whole scenario).
            "slo_window_ms": 10_000,
            # The sim's service model charges per DISPATCH regardless of
            # batch occupancy, so the PR-13 batching queue would absorb
            # a same-model crowd for free and no congestion could ever
            # build. Pinning the batch off models a runtime already at
            # its batch-capacity ceiling — the regime where COPY COUNT
            # is the only remaining lever, i.e. the autoscaler's job.
            "batch_max": 1,
        },
        events=events,
        extra_checks=checks,
    )


# ------------------------------------------------------------------ #
# 15. sharded placement group: serve + drain zero-gap (sharded tentpole)
# ------------------------------------------------------------------ #

_SHARDED_MODEL = "big12x-shard"


def _check_sharded_group(model_id: str, min_shards: int = 2):
    """Non-vacuity for the sharded tentpole: the model really formed a
    placement group (registry shard_count), at least ``min_shards`` LIVE
    pods hold runtime shard copies, and the shard SPI actually ran — a
    run that quietly fell back to single-copy placement (or failed to
    place at all and leaned on the failure-record escape hatch) proves
    nothing about sharded execution."""

    def check(cluster: SimCluster):
        out: list[str] = []
        inst = cluster.first_live().instance
        mr = inst.registry.get(model_id)
        if mr is None:
            return [f"{model_id} lost its registration"]
        if getattr(mr, "shard_count", 0) < min_shards:
            out.append(
                f"{model_id} never formed a placement group "
                f"(shard_count={getattr(mr, 'shard_count', 0)})"
            )
        holders = sorted(
            p.iid for p in cluster.live_pods()
            if p.loader.shard_coords.get(model_id)
        )
        if len(holders) < min_shards:
            out.append(
                f"only {holders} hold runtime shard copies of {model_id} "
                f"(need {min_shards})"
            )
        if not any(p.loader.shard_load_count for p in cluster.pods):
            out.append("no shard load ever ran (vacuous sharded run)")
        return out

    return check


def _check_shard_drain_replanned(iid: str, model_id: str):
    """The drained member's shard must have been re-planned onto a
    survivor (DrainReport.migrated), not dropped or failed — dropping it
    un-replaced would tear the whole group down."""

    def check(cluster: SimCluster):
        report = cluster.drain_reports.get(iid)
        if report is None:
            return [f"{iid} never drained"]
        if model_id not in report.migrated:
            return [
                f"drain of {iid} did not re-plan {model_id}'s shard "
                f"(migrated={report.migrated}, failed={report.failed}, "
                f"dropped={report.dropped})"
            ]
        return []

    return check


def sharded_group_drain_zero_gap() -> Scenario:
    """The sharded-execution tentpole proof: a model 12x the default
    size — bigger than any single pod's 64 MB budget — is served by a
    solver-planned 2-member placement group; probes flow for the whole
    run while one member is gracefully drained. Properties: the group
    forms (non-vacuity via the shard SPI counters), ZERO probe failures
    at any virtual instant (the drain pre-copies the shard to the
    survivor before dropping the member — group-atomic handoff), p99
    within bound at every 10 s checkpoint, and the standard suite's
    ``group_complete_or_absent`` holds at quiescence."""
    from modelmesh_tpu_torch.sim import invariants

    events = [
        # "mlp" path scheme = layer-streamable family: eligible for
        # sharded placement. The id's big12x- prefix makes SimLoader
        # size it at 12x default (96 MB) — no single pod can hold it.
        Event(0, "register", (_SHARDED_MODEL, "sim", "mlp")),
        Event(500, "ensure", (_SHARDED_MODEL,)),
        # One member drains mid-run: its shard must move to the idle
        # survivor with the group serving throughout.
        Event(20_000, "drain", ("sim-0",)),
    ]
    events += [
        Event(t, "invoke", (_SHARDED_MODEL,))
        for t in range(2_000, 45_000, 1_000)
    ]
    return Scenario(
        name="sharded-group-drain-zero-gap",
        seed=115,
        n_instances=3,
        horizon_ms=60_000,
        task_config=_tasks(),
        events=events,
        extra_checks={
            "no_failed_probes": _check_no_request_failures,
            "sharded_group_formed": _check_sharded_group(_SHARDED_MODEL),
            "shard_drain_replanned": _check_shard_drain_replanned(
                "sim-0", _SHARDED_MODEL
            ),
            "slo_attained": invariants.slo_attained(
                "default: p99<5000ms", window_ms=10_000,
            ),
        },
    )


ALL = (
    fanout_budget_under_first_load_failure,
    promote_publish_suppression,
    lease_expiry_republish,
    delete_reregister_race,
    partition_through_janitor,
    mass_restart_jitter,
    transfer_sender_killed_mid_stream,
    transfer_sender_partitioned_mid_stream,
    rolling_restart_under_zipf_load,
    live_registry_migration_under_load,
    late_eviction_deregister_quiesce,
    slo_under_flash_crowd,
    overload_shed_protects_slo,
    flash_crowd_autoscaled,
    sharded_group_drain_zero_gap,
)


# Name -> factory, for the CLI (python -m modelmesh_tpu_torch.sim --scenario
# NAME) and anything else that addresses scripted scenarios by name.
BY_NAME = {factory.__name__: factory for factory in ALL}


def run_all(step_ms: int = 1_000) -> list[ScenarioResult]:
    results = []
    for factory in ALL:
        result = run_scenario(factory(), step_ms=step_ms)
        print(f"[{'PASS' if result.ok else 'FAIL'}] {result.name} "
              f"wall={result.wall_s:.1f}s")
        if not result.ok:
            print(result.render())
        results.append(result)
    return results
