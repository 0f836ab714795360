"""The port's coordination substrate (``modelmesh_tpu_torch/kv/``: the
in-memory store, the tables, the watch-fed view, sessions and leader
election) against the JAX package's, on the CPU.

- Seeded op scripts (put, CAS, txn, delete, gets, ranges and paged
  ranges, historical reads, batches, lease grant / keepalive / revoke,
  lease expiry on each package's ``VirtualClock``, watches from a start
  revision, the history cap's compaction) run against both packages'
  ``InMemoryKV``: every result (revisions, versions, values, leases,
  ``CasFailed`` and the other raises) and every watcher's event batches
  are equal, exactly.
- ``KVTable``/``BucketedKVTable``: keys, buckets and ids equal for the
  same ids; scans, ``update_or_create`` and ``batch_mutate`` over seeded
  mutations give equal records and equal store contents.
- ``TableView`` follows puts and deletes, its listener events equal to
  the reference view's over one script.
- ``SessionNode`` lives, dies and recovers a lost lease, and
  ``LeaderElection`` hands over: ``tests/test_kv.py``'s session cases on
  the port.
"""

import dataclasses
import time
import types

import numpy as np
import pytest

import modelmesh_tpu.kv.memory as ref_memory
import modelmesh_tpu.kv.store as ref_store
import modelmesh_tpu.kv.table as ref_table
import modelmesh_tpu.records as ref_records
import modelmesh_tpu.utils.clock as ref_clock
import modelmesh_tpu_torch.kv.memory as port_memory
import modelmesh_tpu_torch.kv.store as port_store
import modelmesh_tpu_torch.kv.table as port_table
import modelmesh_tpu_torch.records as port_records
import modelmesh_tpu_torch.utils.clock as port_clock
from modelmesh_tpu_torch.kv import InMemoryKV, LeaderElection, SessionNode

REF = types.SimpleNamespace(memory=ref_memory, store=ref_store,
                            table=ref_table, records=ref_records,
                            clock=ref_clock)
PORT = types.SimpleNamespace(memory=port_memory, store=port_store,
                             table=port_table, records=port_records,
                             clock=port_clock)
KEYS = ["a/1", "a/2", "a/3", "b/1", "b/x/1", "b/x/2", "c", "ca"]
PREFIXES = ["", "a/", "b/", "b/x/", "c", "z/"]
SETTLE_S = 10.0


def _kv(kv):
    return None if kv is None else dataclasses.astuple(kv)


def _events(events):
    return [(ev.type.value, _kv(ev.kv), _kv(ev.prev)) for ev in events]


def _script(seed: int, steps: int = 220) -> list:
    """A seeded op list. Lease ids are the stores' own (1, 2, ...: both
    count from 1), so ops may name leases that are gone or never were.
    Virtual time moves in whole seconds and TTLs end on half seconds,
    so no lease ever expires on the instant of a sweep."""
    rng = np.random.default_rng(seed)
    ops = []
    leases = 0
    for _ in range(steps):
        key = KEYS[int(rng.integers(0, len(KEYS)))]
        val = bytes(rng.integers(0, 256, int(rng.integers(0, 6)),
                                 dtype=np.uint8))
        lid = int(rng.integers(0, leases + 2))
        k = int(rng.integers(0, 20))
        if k < 4:
            ops.append(("put", key, val, lid if rng.random() < 0.3 else 0))
        elif k < 6:
            ops.append(("cas", key, val, int(rng.integers(0, 4))))
        elif k == 6:
            keys = [KEYS[int(i)] for i in rng.integers(0, len(KEYS), 3)]
            ops.append(("txn",
                        [(keys[0], int(rng.integers(0, 3)))],
                        [(keys[1], val), (keys[2], None)],
                        [(keys[2], b"f")]))
        elif k == 7:
            ops.append(("delete", key))
        elif k == 8:
            ops.append(("delete_if", key, int(rng.integers(0, 3))))
        elif k == 9:
            ops.append(("get", key))
        elif k == 10:
            ops.append(("range", PREFIXES[int(rng.integers(0, len(PREFIXES)))]))
        elif k == 11:
            ops.append(("paged", PREFIXES[int(rng.integers(0, len(PREFIXES)))],
                        int(rng.integers(1, 4))))
        elif k == 12:
            ops.append(("grant", float(rng.integers(1, 4)) + 0.5))
            leases += 1
        elif k == 13:
            ops.append(("keepalive", lid))
        elif k == 14:
            ops.append(("revoke", lid))
        elif k == 15:
            ops.append(("advance", int(rng.integers(1, 3))))
        elif k == 16:
            ops.append(("watch_from", PREFIXES[int(rng.integers(0, 4))],
                        None if rng.random() < 0.3
                        else int(rng.integers(0, 60))))
        elif k == 17:
            ops.append(("at", "a/", "b/", int(rng.integers(0, 80))))
        elif k == 18:
            ops.append(("batch", [(KEYS[int(i)], val)
                                  for i in rng.integers(0, len(KEYS), 3)]))
        else:
            ops.append(("compact", int(rng.integers(0, 60))))
    return ops


def _settle(kv, clock, gone=()):
    """Wait until the leases in ``gone`` are swept and the sweeper is
    parked on the virtual clock again (its only sleeper here)."""
    deadline = time.monotonic() + SETTLE_S
    while True:
        if all(not kv.lease_exists(l) for l in gone) and clock.waiters >= 1:
            time.sleep(0.005)  # the sweeper past its wake-up, parked again
            if clock.waiters >= 1:
                return
        if time.monotonic() > deadline:
            raise TimeoutError(f"sweeper did not settle (leases {gone})")
        time.sleep(0.001)


def _run(pkg, script) -> dict:
    """Apply ``script`` to a fresh store of ``pkg`` under its own virtual
    clock; every result and every watcher's batches, normalized."""
    store = pkg.store
    results, watched = [], []
    with pkg.clock.installed(pkg.clock.VirtualClock()) as clock:
        kv = pkg.memory.InMemoryKV(sweep_interval_s=0.1, history_cap=40)
        deadlines: dict[int, float] = {}   # lease -> virtual deadline, s
        next_lease = 1
        try:
            everything = []
            kv.watch("", lambda evs: everything.append(_events(evs)))
            watched.append(everything)
            for op in script:
                name, args = op[0], op[1:]
                now = clock.monotonic()
                try:
                    if name == "put":
                        out = _kv(kv.put(*args))
                    elif name == "cas":
                        out = _kv(kv.put_if_version(*args))
                    elif name == "txn":
                        cmp, ok_ops, bad_ops = args
                        ok, kvs = kv.txn(
                            [store.Compare(k, v) for k, v in cmp],
                            [store.Op(k, v) for k, v in ok_ops],
                            [store.Op(k, v) for k, v in bad_ops])
                        out = (ok, [_kv(x) for x in kvs])
                    elif name == "delete":
                        out = kv.delete(*args)
                    elif name == "delete_if":
                        out = kv.delete_if_version(*args)
                    elif name == "get":
                        out = _kv(kv.get(*args))
                    elif name == "range":
                        out = [_kv(x) for x in kv.range(*args)]
                    elif name == "paged":
                        out = [_kv(x) for x in kv.range_paged(*args)]
                    elif name == "grant":
                        out = kv.lease_grant(args[0])
                        assert out == next_lease
                        deadlines[out] = now + args[0]
                        next_lease += 1
                    elif name == "keepalive":
                        out = kv.lease_keepalive(args[0])
                        if out:
                            deadlines[args[0]] = now + kv.lease_ttl(args[0])
                    elif name == "revoke":
                        out = kv.lease_revoke(args[0])
                        deadlines.pop(args[0], None)
                    elif name == "advance":
                        _settle(kv, clock)
                        clock.advance(args[0] * 1000)
                        now = clock.monotonic()
                        gone = [l for l, d in deadlines.items() if d < now]
                        for l in gone:
                            del deadlines[l]
                        _settle(kv, clock, gone)
                        out = (now, sorted(gone))
                    elif name == "watch_from":
                        got = []
                        kv.watch(args[0], lambda evs, got=got: got.append(
                            _events(evs)), start_rev=args[1])
                        watched.append(got)
                        out = None
                    elif name == "at":
                        out = [_kv(x) for x in kv.range_interval_at(*args)]
                    elif name == "batch":
                        with kv.batch():
                            out = [_kv(kv.put(k, v)) for k, v in args[0]]
                    else:
                        out = kv.compact(args[0])
                except Exception as e:  # noqa: BLE001 — compared by type
                    out = ("raise", type(e).__name__)
                results.append((name, out))
            kv.wait_idle()
            final = (kv.revision, kv.compact_rev,
                     [_kv(x) for x in kv.range("")])
        finally:
            kv.close()
    return {"results": results, "watched": watched, "final": final}


@pytest.mark.parametrize("seed", range(5))
def test_op_scripts_match_reference(seed):
    script = _script(seed)
    want = _run(REF, script)
    got = _run(PORT, script)
    for i, (a, b) in enumerate(zip(got["results"], want["results"])):
        assert a == b, (i, script[i])
    assert got["final"] == want["final"]
    assert len(got["watched"]) == len(want["watched"])
    for a, b in zip(got["watched"], want["watched"]):
        assert a == b
    # The scripts reach what they mean to: CAS losses, expiries, replays.
    names = [r for r in got["results"]]
    assert ("cas", ("raise", "CasFailed")) in names
    assert any(n == "advance" and out[1] for n, out in names)
    assert got["final"][1] > 0        # the history cap compacted


def test_store_surface_matches_reference():
    """The SPI names and the exception/enum/dataclass shapes."""
    for name in ("KeyValue", "WatchEvent", "Compare", "Op"):
        ours = [f.name for f in dataclasses.fields(getattr(port_store, name))]
        theirs = [f.name for f in dataclasses.fields(getattr(ref_store, name))]
        assert ours == theirs, name
    assert [e.value for e in port_store.EventType] == [
        e.value for e in ref_store.EventType]
    for name in ("CasFailed", "CompactedRevision", "FutureRevision",
                 "WatchHandle", "KVStore"):
        assert hasattr(port_store, name), name
    kv = InMemoryKV()
    try:
        assert kv.max_value_bytes() is None
        kv.check_value_size(b"x" * 100)
    finally:
        kv.close()


# -- tables -----------------------------------------------------------------

TABLE_IDS = ["m0", "model-17", "a/b/c", "0a/legacy-looking", "ü-modèle",
             "x" * 200, "", "42"]


def test_table_keys_and_buckets_match_reference():
    rng = np.random.default_rng(5)
    ids = TABLE_IDS + [f"m{int(i)}" for i in rng.integers(0, 10**9, 300)]
    for n_buckets in (128, 7):
        a = ref_table.BucketedKVTable(None, "mm/registry",
                                      ref_records.ModelRecord, n_buckets)
        b = port_table.BucketedKVTable(None, "mm/registry",
                                       port_records.ModelRecord, n_buckets)
        for id_ in ids:
            assert b._bucket(id_) == a._bucket(id_)
            assert b._key(id_) == a._key(id_) == b.raw_key(id_)
            assert b.flat_key(id_) == a.flat_key(id_)
            assert b.key_to_id(b._key(id_)) == a.key_to_id(a._key(id_)) == id_
            assert b.key_to_id(b.flat_key(id_)) == a.key_to_id(a.flat_key(id_))
    flat_a = ref_table.KVTable(None, "mm/instances",
                               ref_records.InstanceRecord)
    flat_b = port_table.KVTable(None, "mm/instances/",
                                port_records.InstanceRecord)
    assert flat_b.prefix == flat_a.prefix == "mm/instances/"
    for id_ in ids:
        assert flat_b.raw_key(id_) == flat_a.raw_key(id_)
    assert (port_table.move_txn_parts("t", "l", b"v", 3, 9)[1][0].key
            == ref_table.move_txn_parts("t", "l", b"v", 3, 9)[1][0].key)


def _table_run(pkg, seed: int) -> dict:
    """Seeded registry mutations through a BucketedKVTable (put,
    update_or_create, batch_mutate with an extra op, delete,
    conditional_delete), then a scan."""
    rng = np.random.default_rng(seed)
    kv = pkg.memory.InMemoryKV()
    out = []
    try:
        table = pkg.table.BucketedKVTable(kv, "mm/registry",
                                          pkg.records.ModelRecord)
        ids = [f"m{i}" for i in range(12)]
        for _ in range(80):
            id_ = ids[int(rng.integers(0, len(ids)))]
            k = int(rng.integers(0, 5))
            size = int(rng.integers(1, 500))
            if k == 0:
                rec = table.put(id_, pkg.records.ModelRecord(
                    model_type="t", size_units=size))
                out.append(("put", rec.version))
            elif k == 1:
                def mutate(cur, size=size, iid=f"i{size % 5}"):
                    if cur is None:
                        return pkg.records.ModelRecord(size_units=size)
                    cur.promote_loaded(iid, size)
                    return cur
                rec = table.update_or_create(id_, mutate)
                out.append(("uoc", rec.version, rec.to_bytes()))
            elif k == 2:
                other = ids[int(rng.integers(0, len(ids)))]

                def drop(cur):
                    return None

                def bump(cur, size=size):
                    if cur is None:
                        return None
                    cur.size_units = size
                    return cur
                res = table.batch_mutate(
                    [(id_, bump), (other, drop)] if other != id_
                    else [(id_, bump)],
                    extra_ops=[pkg.store.Op("mm/marker", b"%d" % size)])
                out.append(("batch", sorted(
                    (i, None if r is None else (r.version, r.to_bytes()))
                    for i, r in res.items())))
            elif k == 3:
                out.append(("delete", table.delete(id_)))
            else:
                cur = table.get(id_)
                out.append(("cdel", table.conditional_delete(
                    id_, cur.version if cur and rng.random() < 0.7 else 99)))
        out.append(("scan", [(i, key, r.version, r.to_bytes())
                             for i, key, r in table.scan(page_size=3)]))
        out.append(("items", [(i, r.to_bytes()) for i, r in table.items()]))
        out.append(("store", [_kv(x) for x in kv.range("")]))
    finally:
        kv.close()
    return out


@pytest.mark.parametrize("seed", range(3))
def test_table_mutations_match_reference(seed):
    assert _table_run(PORT, seed) == _table_run(REF, seed)


def _view_run(pkg) -> list:
    """A TableView over the instances table fed puts, updates and
    deletes (one a lease expiry by revoke): its listener's events."""
    kv = pkg.memory.InMemoryKV()
    events = []
    try:
        table = pkg.table.KVTable(kv, "mm/instances",
                                  pkg.records.InstanceRecord)
        table.put("i0", pkg.records.InstanceRecord(zone="a"))
        view = pkg.table.TableView(table)
        view.add_listener(lambda ev, id_, rec: events.append(
            (ev.value, id_, None if rec is None else rec.to_bytes())))
        try:
            view.wait_ready()
            lease = kv.lease_grant(30.0)
            table.put("i1", pkg.records.InstanceRecord(zone="b"), lease)
            table.put("i2", pkg.records.InstanceRecord(capacity_units=5))
            rec = table.get("i0")
            rec.used_units = 3
            table.conditional_set("i0", rec)
            table.delete("i2")
            kv.lease_revoke(lease)
            kv.put("mm/other", b"not in the table")
            view.wait_for(lambda v: "i0" in v and "i1" not in v
                          and "i2" not in v and v.get("i0").used_units == 3)
            kv.wait_idle()
            snap_epoch, items = view.snapshot()
            events.append(("items", sorted(
                (i, r.to_bytes(), r.version) for i, r in items)))
            events.append(("len", len(view), "i0" in view))
            assert snap_epoch == view.epoch
        finally:
            view.close()
    finally:
        kv.close()
    return events


def test_table_view_follows_puts_and_deletes():
    got = _view_run(PORT)
    assert got == _view_run(REF)
    assert [e[0] for e in got[:6]] == [
        "added", "added", "updated", "deleted", "deleted", "items"]


# -- sessions and leader election (tests/test_kv.py's session cases) --------

@pytest.fixture
def kv():
    store = InMemoryKV()
    yield store
    store.close()


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


class TestSession:
    def test_session_node_lives_and_dies(self, kv):
        node = SessionNode(kv, "instances/i1", b"rec", ttl_s=0.3)
        try:
            node.start()
            time.sleep(1.0)  # several TTLs: keepalive must sustain it
            assert kv.get("instances/i1") is not None
            assert kv.get("instances/i1").value == b"rec"
        finally:
            node.close()
        assert _wait(lambda: kv.get("instances/i1") is None, 1.0)

    def test_session_node_recovers_lost_lease(self, kv):
        node = SessionNode(kv, "instances/i2", b"rec", ttl_s=0.3,
                           keepalive_interval_s=0.1)
        try:
            node.start()
            kv.lease_revoke(node._lease)     # KV-side lease loss
            assert _wait(lambda: kv.get("instances/i2") is not None, 2.0)
            node.update(b"rec2")
            assert kv.get("instances/i2").value == b"rec2"
        finally:
            node.close()

    def test_leader_election_handover(self, kv):
        changes = {"a": [], "b": []}
        ea = LeaderElection(kv, "leader", "a", changes["a"].append,
                            ttl_s=0.3)
        eb = LeaderElection(kv, "leader", "b", changes["b"].append,
                            ttl_s=0.3)
        try:
            ea.start()
            eb.start()
            assert _wait(lambda: ea.is_leader and not eb.is_leader)
            ea.close()  # the leader departs -> b takes over
            assert _wait(lambda: eb.is_leader, 3.0)
            assert changes["a"] == [True, False]
            assert changes["b"][-1] is True
        finally:
            ea.close()
            eb.close()

    def test_session_expiry_on_virtual_time(self):
        """A session whose keepalive stops is deleted by the store's
        sweeper when its TTL passes on the virtual clock."""
        with port_clock.installed(port_clock.VirtualClock()) as clock:
            store = InMemoryKV()
            node = SessionNode(store, "instances/v", b"r", ttl_s=1.0)
            try:
                node.start()
                for _ in range(20):          # 10 TTLs of kept-alive time
                    clock.advance(500)
                    assert _wait(lambda: clock.waiters >= 2)
                assert store.get("instances/v") is not None
                node._stop.set()             # keepalive thread gone
                node._thread.join(2.0)
                lease = node._lease
                for _ in range(4):
                    clock.advance(500)
                assert _wait(lambda: not store.lease_exists(lease))
                assert store.get("instances/v") is None
            finally:
                node.close()
                store.close()


# -- the debug aids the store's locks and clock go through ------------------

def test_lock_factories_are_plain_by_default_and_check_order(monkeypatch):
    import threading

    from modelmesh_tpu.utils import lockdebug as ref_lockdebug
    from modelmesh_tpu_torch.utils import lockdebug, racedebug

    monkeypatch.delenv("MM_LOCK_DEBUG", raising=False)
    monkeypatch.delenv("MM_RACE_DEBUG", raising=False)
    assert type(lockdebug.mm_lock("X._a")) is type(threading.Lock())
    assert type(lockdebug.mm_rlock("X._a")) is type(threading.RLock())
    assert isinstance(lockdebug.mm_condition("X._c"), threading.Condition)
    assert not racedebug.active()
    monkeypatch.setenv("MM_LOCK_DEBUG", "1")
    lockdebug.reset_validator()
    try:
        a, b = lockdebug.mm_lock("TestOrder._a"), lockdebug.mm_lock(
            "TestOrder._b")
        with a:
            with b:
                assert lockdebug.held_lock_names() == [
                    "TestOrder._a", "TestOrder._b"]
        with b:
            with pytest.raises(lockdebug.LockOrderViolation):
                a.acquire()
        assert not a.locked() and not b.locked()
    finally:
        lockdebug.reset_validator()
    assert lockdebug._LOCK_ORDER_FILE == ref_lockdebug._LOCK_ORDER_FILE


def test_clock_debug_arms_with_a_virtual_clock(monkeypatch):
    from modelmesh_tpu.utils import clockdebug as ref_clockdebug
    from modelmesh_tpu_torch.utils import clockdebug

    assert clockdebug.WALL_CLOCK_RE.pattern == (
        ref_clockdebug.WALL_CLOCK_RE.pattern)
    monkeypatch.setenv("MM_CLOCK_DEBUG", "1")
    with port_clock.installed(port_clock.VirtualClock()):
        assert clockdebug.active()
        time.time()                      # a test file is not product code
        # The port's own code reads wall time only on annotated lines.
        from modelmesh_tpu_torch.serving import tasks

        assert "wall-clock:" in open(tasks.__file__).read()
    assert not clockdebug.active()
    monkeypatch.delenv("MM_CLOCK_DEBUG")
    with port_clock.installed(port_clock.VirtualClock()):
        assert not clockdebug.active()


def test_concurrent_cas_updates_lose_nothing():
    """More writers than cores, each adding to one record through the
    table's CAS retry loop, with a short switch interval: the final count
    is every increment (a lost update would leave it short)."""
    import sys
    import threading

    writers, each = 12, 25
    store = InMemoryKV()
    table = port_table.KVTable(store, "mm/registry", port_records.ModelRecord)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def bump(cur):
            rec = cur or port_records.ModelRecord()
            rec.ref_count += 1
            return rec

        def work():
            for _ in range(each):
                table.update_or_create("m", bump, max_attempts=10_000)

        threads = [threading.Thread(target=work) for _ in range(writers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
        assert table.get("m").ref_count == writers * each
        assert table.get("m").version == writers * each
    finally:
        sys.setswitchinterval(interval)
        store.close()
