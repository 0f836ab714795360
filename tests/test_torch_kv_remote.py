"""The port's remote KV backends (``modelmesh_tpu_torch/kv/service.py``,
``etcd.py`` with ``etcd_server.py``, ``zookeeper.py`` with
``zk_server.py``) against the JAX package's, on the CPU over localhost.

- **The reference's own cases on the port.** ``tests/test_kv.py`` (every
  case on the port's four backends: ``memory``, ``remote``, ``etcd``,
  ``zookeeper``), ``test_kv_reconnect.py``, ``test_kv_compaction.py`` and
  ``test_kv_tls.py`` run here with their imports re-pointed at the port
  (``mirror``): the same cases, the same assertions.
- **Across packages, over the wire.** One seeded script of puts, CAS,
  txns, deletes, leases (grant, keepalive, revoke with its ephemeral
  keys), watches (live and from a start revision) and ranges (plain,
  paged, from a start key) runs four ways per remote scheme: reference
  client against reference server, port client against reference
  server, reference client against port server, port client against port
  server. Every result (values, revisions, versions, leases, raises) is
  equal, field by field; on ``mesh://`` and ``etcd://`` every watcher's
  events are equal one by one, and on ``zookeeper://``, whose watches
  deliver the latest state rather than every step (ZooKeeper's own
  contract), each watcher's folded view is equal at every sync point.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import inspect
import linecache
import re
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest

import modelmesh_tpu.kv.etcd as ref_etcd
import modelmesh_tpu.kv.etcd_server as ref_etcd_server
import modelmesh_tpu.kv.memory as ref_memory
import modelmesh_tpu.kv.service as ref_service
import modelmesh_tpu.kv.store as ref_store
import modelmesh_tpu.kv.zk_server as ref_zk_server
import modelmesh_tpu.kv.zookeeper as ref_zookeeper
import modelmesh_tpu_torch.kv.etcd as port_etcd
import modelmesh_tpu_torch.kv.etcd_server as port_etcd_server
import modelmesh_tpu_torch.kv.memory as port_memory
import modelmesh_tpu_torch.kv.service as port_service
import modelmesh_tpu_torch.kv.store as port_store
import modelmesh_tpu_torch.kv.zk_server as port_zk_server
import modelmesh_tpu_torch.kv.zookeeper as port_zookeeper

TESTS = Path(__file__).resolve().parent


def port_source(ref_test: str) -> str:
    """``tests/<ref_test>.py`` with every ``modelmesh_tpu.`` name and
    every ``from modelmesh_tpu import`` re-pointed at the port."""
    src = (TESTS / f"{ref_test}.py").read_text()
    return re.sub(r"\bmodelmesh_tpu(?=\.|\s+import\b)",
                  "modelmesh_tpu_torch", src)


def _select(tree: ast.Module, only) -> ast.Module:
    """The top-level statements of ``tree`` that the definitions named in
    ``only`` need: those definitions, and every statement binding a name
    they (or a statement already taken) read, or a fixture they request,
    taken in source order."""
    def bound(node):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            return {node.name}
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            return {(a.asname or a.name).split(".")[0] for a in node.names}
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [
                node.target]
            return {n.id for t in targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)}
        return set()

    def needs(node):
        names = {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
        for fn in ast.walk(node):
            if isinstance(fn, ast.FunctionDef):
                names |= {a.arg for a in fn.args.args}
        return names

    body = tree.body
    missing = set(only) - {n for node in body for n in bound(node)}
    if missing:
        raise AssertionError(f"not in the module: {sorted(missing)}")
    keep = {i for i, node in enumerate(body) if bound(node) & set(only)}
    want = set().union(*(needs(body[i]) for i in keep))
    while True:
        more = {i for i, node in enumerate(body)
                if i not in keep and bound(node) & want}
        if not more:
            break
        keep |= more
        want = want.union(*(needs(body[i]) for i in more))
    return ast.Module(body=[body[i] for i in sorted(keep)], type_ignores=[])


def _is_fixture(obj) -> bool:
    return hasattr(obj, "_fixture_function") or hasattr(
        obj, "_pytestfixturefunction")


def _class_fixture(fixture):
    """``fixture`` (a module-level, function-scoped fixture without
    arguments or params) as a fixture of a test class."""
    fn = fixture.__wrapped__
    marker = getattr(fixture, "_fixture_function_marker", None)
    if inspect.signature(fn).parameters or (
            marker is not None and (marker.scope != "function"
                                    or marker.params is not None)):
        raise AssertionError(f"cannot adapt fixture {fixture.name!r}")
    if inspect.isgeneratorfunction(fn):
        def adapter(self):
            yield from fn()
    else:
        def adapter(self):
            return fn()
    return pytest.fixture(name=fixture.name)(adapter)


def mirror(ref_test: str, into: dict, only=None) -> list[str]:
    """Run the reference test module ``ref_test`` on the port: its source
    (``port_source``) is executed as a module of its own, and its test
    classes, module-level test functions and fixtures are exported into
    ``into`` (the calling test module's globals). ``only`` names the
    classes and functions to take from a module whose other cases need
    what the port does not have: then only they, and the statements
    they need (``_select``), are executed. A fixture whose name ``into``
    already holds (two mirrored modules each with a ``wire``) goes to
    each of the module's classes instead, as a class fixture. Returns
    the exported class and function names."""
    module = types.ModuleType(f"{into['__name__']}.{ref_test}")
    module.__file__ = str(TESTS / f"{ref_test}.py")
    # Registered before it runs: dataclasses look their module up.
    sys.modules[module.__name__] = module
    ns = module.__dict__
    source = port_source(ref_test)
    tree = ast.parse(source)
    if only is not None:
        tree = _select(tree, only)
    filename = f"<port copy of tests/{ref_test}.py>"
    # Tracebacks show the copy's lines.
    linecache.cache[filename] = (len(source), None,
                                 source.splitlines(True), filename)
    exec(compile(tree, filename, "exec"), ns)
    per_class = {}
    for name, obj in list(ns.items()):
        if not _is_fixture(obj):
            continue
        if name in into:
            per_class[name] = _class_fixture(obj)
        else:
            into[name] = obj
    names = []
    for name, obj in ns.items():
        is_test = name.startswith("test_") and inspect.isfunction(obj)
        is_class = isinstance(obj, type) and name.startswith("Test")
        if not (is_test or is_class):
            continue
        if name in into:
            raise AssertionError(f"{ref_test}.{name} collides")
        if is_test and per_class:
            raise AssertionError(
                f"{ref_test}.{name}: a module-level test cannot take a "
                f"class fixture ({sorted(per_class)})")
        for fname, fixture in per_class.items():
            if fname not in vars(obj):
                setattr(obj, fname, fixture)
        into[name] = obj
        names.append(name)
    return names


def _cases(obj) -> list[str]:
    """The case ids pytest makes of a test function: one per row of its
    ``parametrize`` marks (their ids, or the row's index)."""
    rows = [""]
    for mark in getattr(obj, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        values = list(mark.args[1])
        ids = mark.kwargs.get("ids")
        names = [ids(v) if callable(ids) else ids[i] if ids else str(i)
                 for i, v in enumerate(values)]
        rows = [f"{r}-{n}" if r else n for r in rows for n in names]
    return [f"[{r}]" if r else "" for r in rows]


def twins(ref_test: str, into: dict, only=None) -> tuple[list, list]:
    """The cases of ``tests/<ref_test>.py`` (those named in ``only``, if
    given) and their port twins in ``into``, each as sorted
    ``Class::test[params]`` ids; and the mirrored copy's own names must
    hold nothing of the JAX package."""
    ref = vars(importlib.import_module(f"tests.{ref_test}"))
    copy = vars(sys.modules[f"{into['__name__']}.{ref_test}"])

    def ids(ns, names):
        out = []
        for name in names:
            obj = ns.get(name)
            if inspect.isfunction(obj):
                out += [name + c for c in _cases(obj)]
            elif isinstance(obj, type):
                for attr, fn in sorted(vars(obj).items()):
                    if attr.startswith("test_") and inspect.isfunction(fn):
                        out += [f"{name}::{attr}{c}" for c in _cases(fn)]
        return sorted(out)

    wanted = only if only is not None else [
        n for n, o in ref.items()
        if (n.startswith("test_") and inspect.isfunction(o))
        or (n.startswith("Test") and isinstance(o, type))]
    for name, obj in copy.items():
        origin = getattr(obj, "__module__", None) or getattr(
            obj, "__name__", "")
        if isinstance(origin, str) and (
                origin == "modelmesh_tpu" or origin.startswith(
                    "modelmesh_tpu.")):
            raise AssertionError(f"{ref_test}.{name} is {origin}'s")
    return ids(ref, wanted), ids(into, wanted)


MIRRORED = {
    ref_test: mirror(ref_test, globals())
    for ref_test in ("test_kv", "test_kv_reconnect", "test_kv_compaction",
                     "test_kv_tls")
}


def test_mirrors_hold_every_reference_class():
    """Each mirrored module exports every test class its reference has,
    and the copies import nothing of the JAX package."""
    for ref_test, names in MIRRORED.items():
        src = (TESTS / f"{ref_test}.py").read_text()
        want = re.findall(r"^class (Test\w+)", src, re.M)
        assert sorted(names) == sorted(want), ref_test
        assert not re.search(r"\bmodelmesh_tpu\.", port_source(ref_test))


# -- the seeded cross-package script -----------------------------------------

KEYS = ["a/1", "a/2", "a/3", "b/1", "b/x/1", "b/x/2", "c", "ca"]
# Ranges name a prefix: the etcd client reads the empty one as the empty
# key range in both packages. Watches take "" too.
PREFIXES = ["a/", "b/", "b/x/", "c"]
ROOTS = ["a/", "b/", "c"]
BARRIER = "__barrier__/"
SYNC_EVERY = 15
LEASE_TTL_S = 30.0


def _kv(kv):
    return None if kv is None else dataclasses.astuple(kv)


def _script(seed: int, steps: int = 90) -> list:
    """A seeded op list. Leases are named by their grant's ordinal (the
    run maps ordinals to the store's ids), and live long enough never to
    expire inside a run."""
    rng = np.random.default_rng(seed)
    ops = []
    grants = 0
    for _ in range(steps):
        key = KEYS[int(rng.integers(0, len(KEYS)))]
        val = bytes(rng.integers(0, 256, int(rng.integers(0, 6)),
                                 dtype=np.uint8))
        lease = int(rng.integers(0, grants + 1))  # 0: no lease
        k = int(rng.integers(0, 16))
        if k < 4:
            ops.append(("put", key, val,
                        lease if rng.random() < 0.3 else 0))
        elif k < 6:
            ops.append(("cas", key, val, int(rng.integers(0, 4))))
        elif k == 6:
            keys = [KEYS[int(i)] for i in rng.integers(0, len(KEYS), 3)]
            if len(set(keys)) == 3:
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
            prefix = ROOTS[int(rng.integers(0, len(ROOTS)))]
            ops.append(("range_from", prefix,
                        KEYS[int(rng.integers(0, len(KEYS)))],
                        int(rng.integers(1, 5))))
        elif k == 13 and grants < 3:
            ops.append(("grant",))
            grants += 1
        elif k == 13 or k == 14:
            ops.append(("keepalive", lease))
        else:
            ops.append(("revoke", lease) if rng.random() < 0.3 else
                       ("watch_from", ([""] + PREFIXES)[
                           int(rng.integers(0, 1 + len(PREFIXES)))],
                        None if rng.random() < 0.5
                        else int(rng.integers(0, 30))))
    return ops


class _Watcher:
    """One watch's events (barrier keys dropped) and its folded view."""

    def __init__(self):
        self.events: list[tuple] = []
        self.view: dict[str, tuple] = {}
        self._lock = threading.Lock()

    def __call__(self, events):
        with self._lock:
            for ev in events:
                if ev.kv.key.startswith(BARRIER):
                    continue
                self.events.append((ev.type.value, _kv(ev.kv)))
                if ev.type.value == "PUT":
                    self.view[ev.kv.key] = (ev.kv.value, ev.kv.version)
                else:
                    self.view.pop(ev.kv.key, None)

    def snapshot(self):
        with self._lock:
            return sorted(self.view.items())


REF = types.SimpleNamespace(
    memory=ref_memory, store=ref_store, service=ref_service, etcd=ref_etcd,
    etcd_server=ref_etcd_server, zookeeper=ref_zookeeper,
    zk_server=ref_zk_server)
PORT = types.SimpleNamespace(
    memory=port_memory, store=port_store, service=port_service,
    etcd=port_etcd, etcd_server=port_etcd_server, zookeeper=port_zookeeper,
    zk_server=port_zk_server)


def _served(scheme: str, pkg):
    """Start ``scheme``'s server from ``pkg``; returns (address, stop)."""
    if scheme == "zookeeper":
        zk = pkg.zk_server.ZkWireServer().start()
        return f"127.0.0.1:{zk.port}", zk.stop
    start = (pkg.service.start_kv_server if scheme == "mesh"
             else pkg.etcd_server.start_etcd_server)
    backing = pkg.memory.InMemoryKV(sweep_interval_s=0.05)
    server, port, _ = start(store=backing)

    def stop():
        server.stop(0)
        backing.close()
    return f"127.0.0.1:{port}", stop


def _client(scheme: str, pkg, address: str):
    return {"mesh": lambda: pkg.service.RemoteKV(address),
            "etcd": lambda: pkg.etcd.EtcdKV(address),
            "zookeeper": lambda: pkg.zookeeper.ZookeeperKV(address),
            }[scheme]()


def _sync(kv, watchers, scheme):
    kv.wait_idle()
    if scheme == "zookeeper":
        # The ZooKeeper mirror settles in rounds: idle twice in a row.
        kv.wait_idle()
    return [w.snapshot() for w in watchers]


def _run(scheme: str, client_pkg, server_pkg, script) -> dict:
    store = client_pkg.store
    address, stop = _served(scheme, server_pkg)
    kv = _client(scheme, client_pkg, address)
    results, watchers, syncs = [], [], []
    leases: list[int] = []
    try:
        everything = _Watcher()
        kv.watch("", everything)
        watchers.append(everything)
        for i, op in enumerate(script):
            name, args = op[0], op[1:]
            try:
                if name == "put":
                    key, val, lease = args
                    out = _kv(kv.put(key, val, leases[lease - 1] if lease
                                     else 0))
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
                elif name == "range_from":
                    out = [_kv(x) for x in kv.range_from(*args)]
                elif name == "grant":
                    leases.append(kv.lease_grant(LEASE_TTL_S))
                    out = len(leases)
                elif name == "keepalive":
                    out = (kv.lease_keepalive(leases[args[0] - 1])
                           if args[0] else None)
                elif name == "revoke":
                    out = (kv.lease_revoke(leases[args[0] - 1])
                           if args[0] else None)
                else:
                    w = _Watcher()
                    kv.watch(args[0], w, start_rev=args[1])
                    watchers.append(w)
                    out = None
            except Exception as e:  # noqa: BLE001 — compared by type
                out = ("raise", type(e).__name__)
            results.append((name, out))
            if (i + 1) % SYNC_EVERY == 0:
                syncs.append(_sync(kv, watchers, scheme))
        syncs.append(_sync(kv, watchers, scheme))
        final = [_kv(x) for root in ROOTS for x in kv.range(root)]
        for lid in leases:
            kv.lease_revoke(lid)
    finally:
        kv.close()
        stop()
    return {"results": results, "syncs": syncs, "final": final,
            "events": [w.events for w in watchers], "leases": leases}


PAIRS = {("ref", "ref"): (REF, REF), ("port", "ref"): (PORT, REF),
         ("ref", "port"): (REF, PORT), ("port", "port"): (PORT, PORT)}


@pytest.mark.parametrize("scheme", ["mesh", "etcd", "zookeeper"])
def test_script_matches_across_packages_over_the_wire(scheme):
    script = _script(7)
    assert {op[0] for op in script} >= {
        "put", "cas", "txn", "delete", "delete_if", "get", "range", "paged",
        "range_from", "grant", "keepalive", "revoke", "watch_from"}
    runs = {pair: _run(scheme, *pkgs, script) for pair, pkgs in PAIRS.items()}
    want = runs[("ref", "ref")]
    # The script did real work: writes landed, leases were granted and
    # watches saw events.
    assert want["final"] and want["leases"]
    assert sum(len(e) for e in want["events"]) > 20
    for pair, got in runs.items():
        for i, (a, b) in enumerate(zip(got["results"], want["results"])):
            assert a == b, (pair, i, script[i], a, b)
        assert got["leases"] == want["leases"], pair
        assert got["final"] == want["final"], pair
        assert got["syncs"] == want["syncs"], pair
        if scheme != "zookeeper":
            assert got["events"] == want["events"], pair
