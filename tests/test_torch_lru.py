"""The port's weighted LRU and host-RAM tier (``modelmesh_tpu_torch/
cache/lru.py``) against the JAX package's, on the CPU.

- Seeded op scripts (put, get and its touch, quiet get, force-touch,
  remove and its CAS twin, replace, re-weigh and its CAS twin, capacity
  changes, the ordered iterations) run on both ``WeightedLRUCache``s,
  each under its own package's ``VirtualClock``: every return, every
  eviction-listener call and the weights after each op are equal.
- The same for both ``HostTier``s (put, put-if-room, get, peek, size,
  remove, clear), each under its own package's ``VirtualClock``, since
  the tier stamps recency from ``now_ms``.
- ``tests/test_lru_properties.py``'s shape with hypothesis: a state
  machine drives both caches in lockstep and holds them equal.
"""

import numpy as np
import pytest
from hypothesis import settings, strategies as st
from hypothesis.stateful import RuleBasedStateMachine, invariant, rule

import modelmesh_tpu.cache.lru as ref_lru
import modelmesh_tpu.utils.clock as ref_clock
import modelmesh_tpu_torch.cache.lru as port_lru
import modelmesh_tpu_torch.utils.clock as port_clock

KEYS = [f"k{i}" for i in range(8)]


class Val:
    """A value with identity (the caches' CAS ops compare with ``is``)."""

    def __init__(self, name: str):
        self.name = name


def _name(v):
    return None if v is None else v.name


def _lru_script(seed: int, steps: int = 300) -> list:
    rng = np.random.default_rng(seed)
    ops = []
    n = 0
    for _ in range(steps):
        key = KEYS[int(rng.integers(0, len(KEYS)))]
        ts = int(rng.integers(0, 1000))
        k = int(rng.integers(0, 16))
        if k < 4:
            n += 1
            ops.append(("put_if_absent", key, f"v{n}",
                        int(rng.integers(1, 45)), ts))
        elif k == 4:
            ops.append(("get", key, ts if rng.random() < 0.7 else None))
        elif k == 5:
            ops.append(("get_quietly", key))
        elif k == 6:
            ops.append(("force_last_used", key, ts))
        elif k == 7:
            ops.append(("remove", key))
        elif k == 8:
            ops.append(("remove_if_value", key, bool(rng.random() < 0.6)))
        elif k == 9:
            n += 1
            ops.append(("replace_quietly", key, bool(rng.random() < 0.6),
                        f"v{n}"))
        elif k == 10:
            ops.append(("update_weight", key, int(rng.integers(1, 60))))
        elif k == 11:
            ops.append(("update_weight_if_value", key,
                        bool(rng.random() < 0.6), int(rng.integers(1, 60))))
        elif k == 12:
            ops.append(("set_capacity", int(rng.integers(40, 160))))
        elif k == 13:
            ops.append(("items_used_since", ts))
        elif k == 14:
            ops.append(("last_used", key))
        else:
            ops.append(("oldest_time",))
    return ops


def _run_lru(pkg, ops) -> list:
    """The script on one package's cache, under its own VirtualClock (a
    get without a touch time stamps ``now_ms``)."""
    mod, clock = pkg
    with clock.installed(clock.VirtualClock()):
        return _lru_trace(mod, ops)


def _lru_trace(mod, ops) -> list:
    evicted = []
    cache = mod.WeightedLRUCache(
        100, eviction_listener=lambda k, v, ts: evicted.append(
            (k, v.name, ts)))
    vals: dict = {}
    trace = []
    for op in ops:
        name = op[0]
        try:
            if name == "put_if_absent":
                _, key, vname, w, ts = op
                vals[vname] = Val(vname)
                out = _name(cache.put_if_absent(key, vals[vname], w, ts))
            elif name == "get":
                out = _name(cache.get(op[1], touch_ts=op[2]))
            elif name == "get_quietly":
                out = _name(cache.get_quietly(op[1]))
            elif name == "force_last_used":
                out = cache.force_last_used(op[1], op[2])
            elif name == "remove":
                out = _name(cache.remove(op[1]))
            elif name == "remove_if_value":
                cur = cache.get_quietly(op[1])
                probe = cur if (cur is not None and op[2]) else Val("x")
                out = cache.remove_if_value(op[1], probe)
            elif name == "replace_quietly":
                cur = cache.get_quietly(op[1])
                old = cur if (cur is not None and op[2]) else Val("x")
                vals[op[3]] = Val(op[3])
                out = cache.replace_quietly(op[1], old, vals[op[3]])
            elif name == "update_weight":
                out = cache.update_weight(op[1], op[2])
            elif name == "update_weight_if_value":
                cur = cache.get_quietly(op[1])
                probe = cur if (cur is not None and op[2]) else Val("x")
                out = cache.update_weight_if_value(op[1], probe, op[3])
            elif name == "set_capacity":
                out = cache.set_capacity(op[1])
            elif name == "items_used_since":
                out = [(k, v.name, ts)
                       for k, v, ts in cache.items_used_since(op[1])]
            elif name == "last_used":
                out = cache.last_used(op[1])
            else:
                out = cache.oldest_time()
        except ValueError as e:
            out = ("ValueError", str(e))
        trace.append((op, out, cache.weight, len(cache), cache.capacity,
                      list(evicted)))
        evicted.clear()
    trace.append([(k, v.name, ts) for k, v, ts in cache.descending_items()])
    trace.append([(k, v.name, ts) for k, v, ts in cache.ascending_items()])
    trace.append(sorted(cache.keys()))
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_lru_script_matches_reference(seed):
    ops = _lru_script(seed)
    ref = _run_lru((ref_lru, ref_clock), ops)
    port = _run_lru((port_lru, port_clock), ops)
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert a == b
    # The script reaches eviction, the CAS failures and the oversized put.
    flat = [t for t in ref[:-3]]
    assert any(t[5] for t in flat)
    assert any(t[1] is False for t in flat)


def _tier_script(seed: int, steps: int = 200) -> list:
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(steps):
        key = KEYS[int(rng.integers(0, len(KEYS)))]
        k = int(rng.integers(0, 10))
        if k < 3:
            ops.append(("put", key, f"s{i}", int(rng.integers(0, 500))))
        elif k < 5:
            ops.append(("put_if_room", key, f"s{i}",
                        int(rng.integers(1, 400))))
        elif k == 5:
            ops.append(("get", key))
        elif k == 6:
            ops.append(("peek", key))
        elif k == 7:
            ops.append(("size_of", key))
        elif k == 8:
            ops.append(("remove", key))
        else:
            ops.append(("clear",) if rng.random() < 0.1 else ("keys",))
        ops.append(("advance", int(rng.integers(0, 3))))
    return ops


def _run_tier(pkg, ops, capacity: int) -> list:
    lru, clock = pkg
    trace = []
    with clock.installed(clock.VirtualClock()) as vc:
        evicted = []
        tier = lru.HostTier(capacity, eviction_listener=lambda k, v, n:
                            evicted.append((k, v, n)))
        for op in ops:
            name = op[0]
            if name == "advance":
                vc.advance(op[1])
                continue
            if name in ("put", "put_if_room"):
                out = getattr(tier, name)(op[1], op[2], op[3])
            elif name == "clear":
                out = tier.clear()
            elif name == "keys":
                out = sorted(tier.keys())
            else:
                out = getattr(tier, name)(op[1])
            trace.append((op, out, tier.used_bytes, len(tier),
                          list(evicted)))
            evicted.clear()
    return trace


@pytest.mark.parametrize("seed,capacity", [(0, 1000), (1, 1000), (2, 0),
                                           (3, 600)])
def test_host_tier_script_matches_reference(seed, capacity):
    ops = _tier_script(seed)
    ref = _run_tier((ref_lru, ref_clock), ops, capacity)
    port = _run_tier((port_lru, port_clock), ops, capacity)
    assert ref == port
    if capacity:
        assert any(t[4] for t in ref)


def test_now_ms_is_the_clock_reexport():
    assert port_lru.now_ms is port_clock.now_ms
    from modelmesh_tpu_torch import cache

    assert cache.now_ms is port_clock.now_ms
    assert cache.WeightedLRUCache is port_lru.WeightedLRUCache


TS = st.integers(min_value=0, max_value=1_000_000)
HKEYS = st.sampled_from(KEYS)


class TwinLruMachine(RuleBasedStateMachine):
    """Both packages' caches driven in lockstep: every return and every
    eviction-listener call equal, and the ordered contents equal after
    each rule."""

    def __init__(self):
        super().__init__()
        self.events = {"ref": [], "port": []}
        self.caches = {
            side: mod.WeightedLRUCache(
                100, eviction_listener=lambda k, v, ts, side=side:
                self.events[side].append((k, v.name, ts)))
            for side, mod in (("ref", ref_lru), ("port", port_lru))
        }
        self.n = 0

    def _both(self, fn):
        out = {}
        for side, cache in self.caches.items():
            try:
                out[side] = fn(cache)
            except ValueError as e:
                out[side] = ("ValueError", str(e))
        assert out["ref"] == out["port"]
        assert self.events["ref"] == self.events["port"]
        return out["ref"]

    @rule(k=HKEYS, w=st.integers(1, 130), ts=TS)
    def put_if_absent(self, k, w, ts):
        self.n += 1
        name = f"v{self.n}"
        self._both(lambda c: _name(c.put_if_absent(k, Val(name), w, ts)))

    @rule(k=HKEYS, ts=TS)
    def get(self, k, ts):
        self._both(lambda c: _name(c.get(k, touch_ts=ts)))

    @rule(k=HKEYS, ts=TS)
    def force_last_used(self, k, ts):
        self._both(lambda c: c.force_last_used(k, ts))

    @rule(k=HKEYS)
    def remove(self, k):
        self._both(lambda c: _name(c.remove(k)))

    @rule(k=HKEYS, matching=st.booleans())
    def remove_if_value(self, k, matching):
        def go(c):
            cur = c.get_quietly(k)
            return c.remove_if_value(
                k, cur if (cur is not None and matching) else Val("x"))
        self._both(go)

    @rule(k=HKEYS, w=st.integers(1, 130))
    def update_weight(self, k, w):
        self._both(lambda c: c.update_weight(k, w))

    @rule(cap=st.integers(1, 200))
    def set_capacity(self, cap):
        self._both(lambda c: c.set_capacity(cap))

    @invariant()
    def same_contents(self):
        self._both(lambda c: ([(k, v.name, ts)
                               for k, v, ts in c.descending_items()],
                              c.weight, c.capacity, c.oldest_time()))


TestTwinLru = TwinLruMachine.TestCase
TestTwinLru.settings = settings(max_examples=40, stateful_step_count=40,
                                deadline=None)
