"""The plan's extraction on the solve's device (``torch_engine``'s
``_plan_parts``): the hottest-first order and the compaction run behind
the solve, and ``finalize_plan`` only reads the views and reorders the
ids.

Every route the dispatch takes (dense, sparse, the incremental re-solve,
the sharded solve on a mesh of "cpu" shards) is held, on the same
solve's indices, to the extraction the host used to run
(``_host_extract``, kept here only as the yardstick), with its one host
sync. The card test repeats the dense route at 100,000 x 1,000.

    python -m pytest tests/test_torch_plan_extract.py -q
    python -m pytest --noconftest tests/test_torch_plan_extract.py -m card
"""

import numpy as np
import pytest
import torch

from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.ops.solve import SolveConfig
from modelmesh_tpu_torch.parallel import mesh as mesh_mod
from modelmesh_tpu_torch.placement import torch_engine as te
from modelmesh_tpu_torch.placement.synthetic import synthetic_records
from modelmesh_tpu_torch.records import InstanceRecord, ModelRecord

N, M = 300, 40          # 300 rows pad to a bucket of 384
NOW = 5_000_000


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def pinned_clock(monkeypatch):
    monkeypatch.setattr(te, "now_ms", lambda: NOW)


def _host_extract(indices, valid, rates, model_ids):
    """The extraction ``finalize_plan`` ran on the host before the order
    and the compaction moved to the device: (ids, counts, flat)."""
    n = len(model_ids)
    idxa = indices[:n].astype(np.int32)
    counts = valid[:n].sum(axis=1).astype(np.uint8)
    order = np.argsort(-rates, kind="stable")
    idxo, counts = idxa[order], counts[order]
    mask = np.arange(idxo.shape[1], dtype=np.uint8)[None, :] < counts[:, None]
    return [model_ids[i] for i in order.tolist()], counts, idxo[mask]


class _NoGpuType:
    """Type "gpu" has no candidate instance: its model gets 0 copies."""

    def is_candidate(self, mtype, labels):
        return mtype != "gpu"

    def is_preferred(self, mtype, labels):
        return True


def _fleet():
    """300 models with rates in a few planted ties (rpm 0 reads the
    recency proxy, equal for equal last_used), one model of a type no
    instance takes (0 copies) and one loaded on ten instances (8
    copies)."""
    models = []
    for i in range(N):
        mr = ModelRecord(model_type="gpu" if i == 7 else f"t{i % 3}",
                         size_units=16 + i % 5, last_used=1_000 + i % 2)
        models.append((f"m{i}", mr))
    for j in range(10):
        models[11][1].promote_loaded(f"i{j}", 1000)
    instances = [
        (f"i{j}", InstanceRecord(capacity_units=4_000, used_units=100,
                                 zone="ab"[j % 2], lru_ts=1_000))
        for j in range(M)
    ]
    rpm = {f"m{i}": (i % 4) * 10 for i in range(N)}
    return te.snapshot_columns(models, instances, rpm,
                               constraints=_NoGpuType())


def _dispatch(route, cols):
    if route == "dense":
        return te.dispatch_solve(cols, seed=5, device="cpu")
    if route == "sparse":
        return te.dispatch_solve(cols, seed=5, device="cpu",
                                 config=SolveConfig(topk=16))
    if route == "incremental":
        full = te.dispatch_solve(cols, seed=5, device="cpu")
        te.finalize_plan(full)
        sol = full.sol
        base = te.SolveBase(
            indices=sol.indices, valid=sol.valid, g=sol.g,
            prices=sol.prices, row_err=sol.row_err, seed=5,
        )
        return te.dispatch_solve(cols, seed=5, base=base, device="cpu",
                                 dirty_rows=[0, 7, 11, 150, N - 1])
    mesh = mesh_mod.make_mesh((2, 1), ["cpu", "cpu"])
    try:
        return te.dispatch_solve(cols, seed=5, mesh=mesh)
    finally:
        mesh.close()


def _assert_extracted(plan, pending):
    """The plan's columns are the host extraction's, on the same solve's
    indices, in its dtypes."""
    cols, sol = pending.cols, pending.sol
    ids, counts, flat = _host_extract(
        sol.indices.cpu().numpy(), sol.valid.cpu().numpy(), cols.rates,
        cols.model_ids,
    )
    got_ids, got_counts, got_flat, inst_ids = plan._columnar
    assert got_ids == ids
    assert got_counts.dtype == counts.dtype == np.uint8
    np.testing.assert_array_equal(got_counts, counts)
    assert got_flat.dtype == flat.dtype == np.int32
    np.testing.assert_array_equal(got_flat, flat)
    assert inst_ids == cols.instance_ids
    return counts


@pytest.mark.parametrize("route", ["dense", "sparse", "incremental",
                                   "sharded"])
def test_plan_equals_host_extraction(route):
    cols = _fleet()
    pending = _dispatch(route, cols)
    assert pending.path == route
    syncs0 = device_mod.host_syncs
    plan = te.finalize_plan(pending)
    assert device_mod.host_syncs - syncs0 == 1      # the one readback
    assert plan.stats["host_syncs"] == pending.dispatch_syncs + 1
    counts = _assert_extracted(plan, pending)
    assert counts.min() == 0 and counts.max() == 8
    assert len(np.unique(cols.rates)) < N // 10     # ties, planted
    # Order (i32[n]), counts (u8, padded to whole i32s), the compacted
    # block (i32[n * 8]), then overflow, row_err, g and prices (f32).
    m_pad = pending.sol.load.shape[0]
    assert plan.stats["readback_bytes"] == (
        4 * N + 4 * ((N + 3) // 4) + 4 * N * 8 + 4 * (2 + 2 * m_pad))


def test_finalize_enqueues_a_missing_readback():
    """A pending solve without its readback (one built by hand) uploads
    the rates and gives the same plan."""
    cols = _fleet()
    pending = _dispatch("dense", cols)
    late = pending._replace(readback=None)
    a, b = te.finalize_plan(pending), te.finalize_plan(late)
    assert a._columnar[0] == b._columnar[0]
    for x, y in zip(a._columnar[1:3], b._columnar[1:3]):
        np.testing.assert_array_equal(x, y)
    assert b.stats["host_syncs"] == 1


@pytest.mark.parametrize("rates", [
    [],
    [3.0],
    [0.0, -0.0, 0.0, -0.0],
    [1.0, np.nan, 2.0, -np.nan, np.inf, -np.inf, 1.0, np.nan],
    [np.float32(1e-45), -np.float32(1e-45), 0.0, 5.0, 5.0, -7.5],
    list(np.random.default_rng(3).integers(0, 6, 1000) * 0.5),
    list(np.random.default_rng(4).standard_normal(777)),
], ids=["empty", "one", "signed-zeros", "nan-inf", "tiny", "ties", "normal"])
def test_hottest_first_is_numpys_stable_argsort(rates):
    rates = np.asarray(rates, np.float32)
    got = te._hottest_first(torch.from_numpy(rates)).numpy()
    np.testing.assert_array_equal(got, np.argsort(-rates, kind="stable"))


def test_ids_reorder_from_the_snapshot_array():
    """The snapshot holds its ids once as an object array, delta patches
    keep it, and columns without one still extract."""
    models, instances = synthetic_records(64, 8)
    cols, cache = te.snapshot_columns(models, instances, return_cache=True)
    assert isinstance(cols.model_ids, te.IdList)
    assert cols.model_ids == [mid for mid, _ in models]
    assert list(cols.model_ids.array) == cols.model_ids
    patched = te.patch_columns(cache, models, instances, None, {"m3"})
    assert patched.model_ids.array is cols.model_ids.array
    plain = cols._replace(model_ids=list(cols.model_ids))
    pending = te.dispatch_solve(plain, seed=1, device="cpu")
    _assert_extracted(te.finalize_plan(pending), pending)


@pytest.mark.card
def test_dense_plan_equals_host_extraction_on_the_card(cuda_card,
                                                       monkeypatch):
    """The dense route at 100,000 x 1,000 on the card: the same plan as
    the host extraction, one host sync, a readback below the padded
    [131072, 9] block's, and no sync in the order or the compaction
    under torch's sync debug mode."""
    monkeypatch.setenv("MM_SOLVER_SPARSE", "0")
    models, instances = synthetic_records(100_000, 1_000)
    rpm = {mid: int(v) for (mid, _), v in zip(
        models, np.random.default_rng(0).integers(0, 50, len(models)))}
    cols = te.snapshot_columns(models, instances, rpm)
    pending = te.dispatch_solve(cols, seed=9, device=cuda_card)
    assert pending.path == "dense"
    plan = te.finalize_plan(pending)
    assert plan.stats["host_syncs"] == pending.dispatch_syncs + 1
    _assert_extracted(plan, pending)
    m_pad = pending.sol.load.shape[0]
    assert plan.stats["readback_bytes"] < 131_072 * 9 * 4 + 4 * (2 + 2 * m_pad)
    rates = device_mod.upload(cols.rates, cuda_card)
    torch.cuda.synchronize(cuda_card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        rb = te._enqueue_readback(pending.sol, rates, len(models))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host = device_mod.finish_readback(rb).numpy()
    rank = te._unpack_plan(host, len(models), 8)[0]
    order = np.argsort(-cols.rates, kind="stable")
    np.testing.assert_array_equal(rank[order], np.arange(len(models)))
