"""The port's greedy fallback and the pieces it reads
(``placement/greedy.py``, ``placement/shadow.py``,
``serving/route_cache.py``, ``serving/timestats.py``,
``serving/constraints.py``, ``reconfig/rolling.py``) against the JAX
package's, on the CPU.

- Seeded fleets with zones, labels, drained, disabled and shutting-down
  instances, exclusions, loading and sharded copies and a mixed
  ``instance_version`` rollout: the port's and the reference's
  ``GreedyStrategy`` give equal ``choose_load_target``,
  ``choose_serve_target``, ``rank_serve_candidates`` and
  ``choose_group_targets``, bare, with ``TimeStats``, with
  ``TypeConstraints`` and with both. Exact equality; the clock is pinned
  in both packages.
- ``ShadowStrategy``: equal agreement counts and divergences.
- The route cache: equal picks, lookups and counters over the same
  candidate sets, feedback and demotions.
- The rolling-upgrade helpers, the load-time statistics and the
  constraints' parsing: equal outputs.
"""

import numpy as np
import pytest

import modelmesh_tpu.placement.greedy as ref_greedy
import modelmesh_tpu.placement.shadow as ref_shadow
import modelmesh_tpu.placement.strategy as ref_spi
import modelmesh_tpu.reconfig.rolling as ref_rolling
import modelmesh_tpu.records as ref_records
import modelmesh_tpu.serving.constraints as ref_constraints
import modelmesh_tpu.serving.route_cache as ref_route
import modelmesh_tpu.serving.timestats as ref_timestats
import modelmesh_tpu_torch.placement.greedy as port_greedy
import modelmesh_tpu_torch.placement.shadow as port_shadow
import modelmesh_tpu_torch.placement.strategy as port_spi
import modelmesh_tpu_torch.reconfig.rolling as port_rolling
import modelmesh_tpu_torch.records as port_records
import modelmesh_tpu_torch.serving.constraints as port_constraints
import modelmesh_tpu_torch.serving.route_cache as port_route
import modelmesh_tpu_torch.serving.timestats as port_timestats

NOW = 1_700_000_000_000
LABELS = ["gpu", "zone-a", "fast", "big"]
VERSIONS = ["", "v1.2", "1.2", "v1.9", "v1.10", "v2.0-rc1"]
TYPES = ["t0", "t1", "t2", "t3"]
CONSTRAINTS = {"types": {
    "t0": {"required": [], "preferred": ["gpu"]},
    "t1": {"preferred": ["fast", "zone-a"]},
    "t2": {"required": ["big"], "preferred": ["nothing-has-this"]},
    "_default": {"required": []},
}}


class Pkg:
    def __init__(self, greedy, shadow, spi, records, constraints, timestats,
                 route, rolling):
        self.greedy, self.shadow, self.spi = greedy, shadow, spi
        self.records, self.constraints = records, constraints
        self.timestats, self.route, self.rolling = timestats, route, rolling


REF = Pkg(ref_greedy, ref_shadow, ref_spi, ref_records, ref_constraints,
          ref_timestats, ref_route, ref_rolling)
PORT = Pkg(port_greedy, port_shadow, port_spi, port_records,
           port_constraints, port_timestats, port_route, port_rolling)


@pytest.fixture(autouse=True)
def _pinned_clock(monkeypatch):
    for mod in (ref_greedy, port_greedy, ref_route, port_route,
                ref_constraints, port_constraints):
        monkeypatch.setattr(mod, "now_ms", lambda: NOW)


def _fleet(seed: int, n: int = 60):
    """Seeded instance and model field dicts, and request specs, with
    many ties (small ranges) so the tie-breaks are exercised; seeds from
    6 on make 4-instance fleets, where exclusions empty the pool."""
    m = 40 if seed < 6 else 4
    rng = np.random.default_rng(seed)
    rollout = rng.random() < 0.6
    insts = []
    for j in range(m):
        cap = int(rng.choice([0, 1000, 2000, 4000]))
        insts.append((f"i{j:02d}", {
            "capacity_units": cap,
            "used_units": int(rng.integers(0, 5)) * 500,
            "lru_ts": int(rng.choice([0, NOW - 10 * 60_000,
                                      NOW - 2 * 60_000, NOW - 1])),
            "req_per_minute": int(rng.integers(0, 4)),
            "zone": f"z{rng.integers(0, 3)}",
            "labels": sorted({LABELS[int(i)] for i in
                              rng.integers(0, len(LABELS),
                                           rng.integers(0, 3))}),
            "shutting_down": bool(rng.random() < 0.08),
            "disabled": bool(rng.random() < 0.08),
            "draining": bool(rng.random() < 0.1),
            "instance_version": (str(rng.choice(VERSIONS)) if rollout
                                 else "v1.2"),
        }))
    ids = [iid for iid, _ in insts]
    models = []
    for i in range(n):
        pick = lambda k: [ids[int(x)] for x in  # noqa: E731
                          rng.choice(m, k, replace=False)]
        shard_count = int(rng.choice([0, 0, 2, 3]))
        models.append((f"m{i}", {
            "model_type": str(rng.choice(TYPES)),
            "size_units": int(rng.integers(0, 900)),
            "instance_ids": {iid: int(NOW - rng.choice([1, 5_000, 60_000,
                                                        10**7]))
                             for iid in pick(int(rng.integers(0, 4)))},
            "loading_instances": {iid: int(NOW - rng.choice([100, 30_000,
                                                             10**6]))
                                  for iid in pick(int(rng.integers(0, 3)))},
            "shard_count": shard_count,
            "shard_instances": {iid: int(rng.integers(0, max(shard_count, 1)
                                                      + 1))
                                for iid in pick(int(rng.integers(0, 3)))},
        }))
    requests = []
    for i in range(n):
        requests.append({
            "model": i,
            "required_units": int(rng.choice([0, 100, 1500, 10**6])),
            "requesting_instance": (ids[int(rng.integers(0, m))]
                                    if rng.random() < 0.5 else "elsewhere"),
            "exclude": frozenset(ids[int(x)] for x in
                                 rng.integers(0, m, rng.integers(0, 6))),
            "shard_count": int(rng.integers(1, 5)),
            "shard_units": int(rng.choice([0, 500, 1500, 10**6])),
        })
    return insts, models, requests


def _built(pkg, fleet):
    insts, models, requests = fleet
    view = pkg.spi.ClusterView(
        [(iid, pkg.records.InstanceRecord(**f)) for iid, f in insts])
    recs = [(mid, pkg.records.ModelRecord(**f)) for mid, f in models]
    reqs = [pkg.spi.PlacementRequest(
        model_id=recs[r["model"]][0], model=recs[r["model"]][1],
        required_units=r["required_units"],
        requesting_instance=r["requesting_instance"], exclude=r["exclude"])
        for r in requests]
    return view, recs, reqs


def _stats(pkg, samples):
    ts = pkg.timestats.TimeStats()
    for key, ms in samples:
        ts.record(key, ms)
    return ts


def _greedy(pkg, kind: str, samples):
    ts = _stats(pkg, samples) if kind in ("stats", "both") else None
    tc = (pkg.constraints.TypeConstraints(CONSTRAINTS)
          if kind in ("constraints", "both") else None)
    return pkg.greedy.GreedyStrategy(time_stats=ts, constraints=tc)


def _cands(cands):
    return [(c.iid, c.draining, c.weight, c.loading) for c in cands]


def _decisions(pkg, fleet, kind, samples):
    view, recs, reqs = _built(pkg, fleet)
    strat = _greedy(pkg, kind, samples)
    out = []
    for req, spec in zip(reqs, fleet[2]):
        out.append(("load", strat.choose_load_target(req, view)))
        out.append(("group", strat.choose_group_targets(
            req, view, spec["shard_count"], spec["shard_units"])))
        out.append(("serve", strat.choose_serve_target(
            req.model, view, req.exclude)))
        out.append(("rank", _cands(strat.rank_serve_candidates(
            req.model, view, req.exclude))))
    return out


def _samples(seed):
    rng = np.random.default_rng(seed + 1000)
    # t0 well sampled (slow loads), t1 under min_samples, t2/t3 none.
    return ([("t0", float(rng.normal(40_000, 8_000))) for _ in range(6)]
            + [("t1", 50.0), ("t1", -1.0)])


@pytest.mark.parametrize("kind", ["bare", "stats", "constraints", "both"])
@pytest.mark.parametrize("seed", range(8))
def test_greedy_decisions_match_reference(seed, kind):
    fleet = _fleet(seed)
    samples = _samples(seed)
    got = _decisions(PORT, fleet, kind, samples)
    want = _decisions(REF, fleet, kind, samples)
    assert got == want


def test_greedy_fleets_reach_every_branch():
    """Over the seeds above: LOAD_HERE, no load target, no serve target,
    a ride-the-loading-copy pick, a draining copy ranked, a failed and a
    planned group."""
    got = [d for seed in range(8) for kind in ("bare", "both")
           for d in _decisions(PORT, _fleet(seed), kind, _samples(seed))]
    assert any(v == port_spi.LOAD_HERE for k, v in got if k == "load")
    assert any(v is None for k, v in got if k == "load")
    assert any(v is None for k, v in got if k == "serve")
    assert any(v and v[0][3] for k, v in got if k == "rank")
    assert any(v and any(c[1] for c in v) for k, v in got if k == "rank")
    assert any(v is None for k, v in got if k == "group")
    assert any(v for k, v in got if k == "group")


def test_constants_and_load_here_match_reference():
    assert port_spi.LOAD_HERE == ref_spi.LOAD_HERE
    for name in ("FREE_SPACE_SHORTLIST_RATIO", "LRU_SHORTLIST_WINDOW_MS",
                 "RECENT_LOAD_PENALTY_MS"):
        assert getattr(port_greedy, name) == getattr(ref_greedy, name)
    assert port_timestats.DEFAULT_EXPECT_MS == ref_timestats.DEFAULT_EXPECT_MS


# -- shadow mode ------------------------------------------------------------

class _Broken(port_spi.PlacementStrategy):
    def choose_load_target(self, req, view):
        if req.model_id.endswith("7"):
            raise RuntimeError("shadow blew up")
        return None

    def choose_serve_target(self, model, view, exclude):
        return None


class _RefBroken(ref_spi.PlacementStrategy):
    choose_load_target = _Broken.choose_load_target
    choose_serve_target = _Broken.choose_serve_target


def _shadow_run(pkg, fleet, broken_cls):
    view, recs, reqs = _built(pkg, fleet)
    outs = []
    for shadow in (
        pkg.greedy.GreedyStrategy(
            constraints=pkg.constraints.TypeConstraints(CONSTRAINTS)),
        broken_cls(),
    ):
        strat = pkg.shadow.ShadowStrategy(pkg.greedy.GreedyStrategy(),
                                          shadow, keep_recent=8)
        for req in reqs:
            outs.append(strat.choose_load_target(req, view))
            outs.append(strat.choose_serve_target(req.model, view,
                                                  req.exclude))
            outs.append(_cands(strat.rank_serve_candidates(
                req.model, view, req.exclude)))
        outs.append(strat.shadow_stats())
    return outs


@pytest.mark.parametrize("seed", range(3))
def test_shadow_agreement_matches_reference(seed):
    fleet = _fleet(seed)
    got = _shadow_run(PORT, fleet, _Broken)
    assert got == _shadow_run(REF, fleet, _RefBroken)
    stats = got[-1]
    assert stats["counts"].get("load_shadow_error", 0) > 0


def test_shadow_fans_attach_points_and_refresh():
    seen = []

    class Solver(port_greedy.GreedyStrategy):
        def adopt(self, plan):
            seen.append(("adopt", plan))

        def refresh(self, models, instances, rpm_fn=None):
            seen.append(("refresh", len(models), len(instances)))
            return "plan"

    primary, solver = port_greedy.GreedyStrategy(), Solver()
    strat = port_shadow.ShadowStrategy(primary, solver)
    strat.time_stats = ts = port_timestats.TimeStats()
    assert primary.time_stats is ts and solver.time_stats is ts
    strat.constraints = tc = port_constraints.TypeConstraints()
    assert strat.constraints is tc and solver.constraints is tc
    strat.adopt("p")
    assert strat.refresh([1, 2], [3]) == "plan"
    assert seen == [("adopt", "p"), ("refresh", 2, 1)]


# -- route cache ------------------------------------------------------------

def _route_run(pkg, fleet, route_d, seed):
    view, recs, reqs = _built(pkg, fleet)
    strat = pkg.greedy.GreedyStrategy()
    cache = pkg.route.RouteCache(enabled=True, ttl_ms=1000,
                                 route_d=route_d, feedback_decay_ms=5000,
                                 seed=seed)
    rng = np.random.default_rng(seed)
    ids = [iid for iid, _ in view.instances]
    out = []
    t = NOW
    for step in range(400):
        t += int(rng.integers(0, 700))
        req = reqs[int(rng.integers(0, len(reqs)))]
        sig = frozenset(req.exclude)
        k = int(rng.integers(0, 6))
        if k == 0:
            cache.load_view.note(pkg.route.LoadFeedback(
                ids[int(rng.integers(0, len(ids)))],
                int(rng.integers(0, 9)), int(rng.integers(0, 9)),
                bool(rng.random() < 0.2)), now=t)
        elif k == 1:
            cache.demote(req.model_id, ids[int(rng.integers(0, len(ids)))])
        elif k == 2:
            iid = ids[int(rng.integers(0, len(ids)))]
            (cache.load_view.begin if rng.random() < 0.6
             else cache.load_view.end)(iid)
        cands = cache.lookup(req.model_id, sig, req.model.version, 1, now=t)
        if cands is None:
            cands = strat.rank_serve_candidates(req.model, view, req.exclude)
            cache.store(req.model_id, sig, req.model.version, 1, cands,
                        now=t)
        out.append((cache.pick(cands, now=t), _cands(cands)))
    fb = pkg.route.LoadFeedback.decode("x", "3,4,1")
    out.append((cache.hits, cache.misses, cache.invalidations, len(cache),
                len(cache.load_view), cache.load_view.notes,
                cache.load_view.demotions, fb.encode(),
                pkg.route.LoadFeedback.decode("x", "junk"),
                cache.load_view.staleness_ms(now=t),
                sorted(cache.load_view.prune(now=t + 10**6))))
    return out


@pytest.mark.parametrize("route_d", [1, 2, 3])
@pytest.mark.parametrize("seed", range(2))
def test_route_cache_picks_match_reference(route_d, seed):
    fleet = _fleet(seed + 10)
    got = _route_run(PORT, fleet, route_d, seed)
    assert got == _route_run(REF, fleet, route_d, seed)
    assert len({p for p, _ in got[:-1] if p}) > 3


def test_route_cache_knobs_from_env(monkeypatch):
    monkeypatch.setenv("MM_ROUTE_D", "3")
    monkeypatch.setenv("MM_ROUTE_CACHE_TTL_MS", "250")
    monkeypatch.setenv("MM_FEEDBACK_DECAY_MS", "900")
    monkeypatch.setenv("MM_ROUTE_CACHE", "off")
    for mod in (port_route, ref_route):
        cache = mod.RouteCache()
        assert (cache.route_d, cache.ttl_ms, cache.load_view.decay_ms,
                cache.enabled) == (3, 250, 900, False)


# -- rolling upgrades, load-time statistics, constraints --------------------

def test_rolling_helpers_match_reference():
    rng = np.random.default_rng(3)
    for _ in range(40):
        insts = [(f"i{j}", {"instance_version": str(rng.choice(VERSIONS))})
                 for j in range(int(rng.integers(1, 9)))]
        a = [(i, ref_records.InstanceRecord(**f)) for i, f in insts]
        b = [(i, port_records.InstanceRecord(**f)) for i, f in insts]
        assert port_rolling.rollout_active(b) == ref_rolling.rollout_active(a)
        assert ([i for i, _ in port_rolling.upversion_shortlist(b)]
                == [i for i, _ in ref_rolling.upversion_shortlist(a)])
        target = str(rng.choice(VERSIONS))
        mu = int(rng.integers(1, 4))
        assert (port_rolling.plan_waves(b, target, mu)
                == ref_rolling.plan_waves(a, target, mu))
    for v in VERSIONS + ["V3", "1.a.2", "x-y_z"]:
        assert port_rolling.version_key(v) == ref_rolling.version_key(v)
    with pytest.raises(ValueError):
        port_rolling.plan_waves([], "v1", 0)
    assert (port_rolling.max_unavailable_default()
            == ref_rolling.max_unavailable_default())


def test_timestats_match_reference():
    rng = np.random.default_rng(4)
    a, b = ref_timestats.TimeStats(max_keys=8), port_timestats.TimeStats(
        max_keys=8)
    for _ in range(300):
        key = f"t{rng.integers(0, 12)}"
        ms = float(rng.normal(500, 300))
        a.record(key, ms)
        b.record(key, ms)
        for k in (key, "t0", "never"):
            assert (b.mean_ms(k), b.expect_ms(k), b.samples(k)) == (
                a.mean_ms(k), a.expect_ms(k), a.samples(k))


def test_constraints_match_reference():
    a = ref_constraints.TypeConstraints.from_json(
        '{"types": {"t0": {"required": ["gpu"], "preferred": ["fast"]}}}')
    b = port_constraints.TypeConstraints.from_json(
        '{"types": {"t0": {"required": ["gpu"], "preferred": ["fast"]}}}')
    insts, _, _ = _fleet(9)
    pa = [(i, ref_records.InstanceRecord(**f)) for i, f in insts]
    pb = [(i, port_records.InstanceRecord(**f)) for i, f in insts]
    for t in ("t0", "t1"):
        assert b.non_candidates(t, pb) == a.non_candidates(t, pa)
        for _, rec in pb:
            assert (b.is_candidate(t, rec.labels), b.is_preferred(
                t, rec.labels)) == (a.is_candidate(t, rec.labels),
                                    a.is_preferred(t, rec.labels))
    assert port_constraints.TypeConstraints.from_json(" ")._types == {}
    for iid in ("mm-7f9c-abcde", "plain", "a-b", "x--y"):
        assert (port_constraints.parse_instance_id(iid)
                == ref_constraints.parse_instance_id(iid))
    fleet = [(f"mm-{rs}-{k}", None) for rs in ("aaa", "bbb") for k in range(2)]
    ta, tb = ref_constraints.UpgradeTracker(), port_constraints.UpgradeTracker()
    assert tb.likely_replaced(fleet) == ta.likely_replaced(fleet)
