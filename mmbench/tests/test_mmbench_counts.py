"""The work counts and peaks of the rooflines, and the top-K tier's two
readers on a synthetic trace."""

from types import SimpleNamespace

import pytest

from mmbench import counts, harness
from mmbench import reference as ref
from mmbench.trace import Summary


def test_cost_matrix_at_the_padded_tier():
    assert counts.cost_bytes(131072, 1024) == 268_435_456


def test_dense_transport():
    nbytes, flops = counts.transport_work(131072, 1024, 10)
    assert nbytes == 10 * (268_435_456 + 4 * 2 * (131072 + 1024))
    assert flops == 10 * 8 * 131072 * 1024
    # Bytes bound it: 80.45 us an iteration at 3.35 TB/s.
    per_iter = counts.least_seconds(nbytes, flops) / 10
    assert per_iter == pytest.approx(80.45e-6, rel=1e-3)


@pytest.mark.parametrize("m, width", [(200, 1), (256, 1), (1000, 2),
                                      (65536, 2), (65537, 4), (10**6, 4)])
def test_pod_ids_take_the_narrowest_integer(m, width):
    assert counts.id_bytes(m) == width


def test_implied_load_counts_the_valid_entries():
    # The cell: 100,000 models of one copy on 1,000 pods: a 2-byte pod
    # index and a 4-byte size per model, a 4-byte load per pod.
    nbytes, flops = counts.implied_load_work(100_000, 1000, 100_000)
    assert nbytes == 100_000 * 2 + 4 * 100_000 + 4 * 1000 == 604_000
    assert flops == 100_000
    assert counts.least_seconds(nbytes, flops) == pytest.approx(0.1803e-6,
                                                                rel=1e-3)
    # Two copies a model: the entries double, the sizes and loads do not.
    more, _ = counts.implied_load_work(100_000, 1000, 200_000)
    assert more - nbytes == 100_000 * 2


def test_select_reads_the_cost_once_and_writes_the_candidates():
    # 100,000 x 1,000, K 24: the bf16 matrix, a 2-byte index and a 4-byte
    # key per candidate.
    nbytes, flops = counts.select_work(100_000, 1000, 24)
    assert nbytes == 2 * 100_000 * 1000 + 100_000 * 24 * (2 + 4)
    assert flops == 2 * 100_000 * 1000
    assert counts.least_seconds(nbytes, flops) == pytest.approx(
        nbytes / 3.35e12)


def test_masked_sinkhorn_reads_the_candidates_and_the_mask():
    it_bytes, it_flops = counts.masked_iteration_work(100_000, 1000, 24)
    assert it_bytes == (100_000 * 24 * 2 + 100_000 * 1000 // 8
                        + 4 * (3 * 100_000 + 2 * 1000))
    assert it_flops == 8 * 100_000 * 24
    row_bytes, row_flops = counts.masked_row_work(100_000, 1000, 24)
    assert row_bytes == (100_000 * 24 * 2 + 100_000 * 1000 // 8
                         + 4 * (100_000 + 1000))
    assert row_flops == 5 * 100_000 * 24


SOLVER = ref.Solver(eps=0.05, sinkhorn_iters=10, auction_iters=8, eta=0.5,
                    tau=1.0, topk=24, sel_width=2, sinkhorn_tol=0.02,
                    sinkhorn_chunk=4, auction_stall_tol=1e-3)


def traced(kernels, stats):
    return SimpleNamespace(
        trace=Summary(window_s=1.0, busy_s=0.5, kernels=kernels,
                      idle_by_host={}),
        stats=stats, n=100_000, m=1000, solver=SOLVER)


def test_select_roofline_counts_each_full_top_k_solve():
    stats = [{"solver_path": "sparse", "topk": 24},
             {"solver_path": "sharded-sparse", "topk": 24},
             {"solver_path": "incremental", "topk": 24}]
    run = traced({"select_kernel<true>": (1e-3, 2)}, stats)
    need = 2 * counts.least_seconds(*counts.select_work(100_000, 1000, 24))
    got = harness.reader("select_roofline")(run)
    assert got == pytest.approx(100.0 * need / 1e-3)


def test_masked_sinkhorn_roofline_counts_iterations_and_gate_reads():
    # 5 iterations: the probe and one chunk, whose error one row product
    # reads; 1 iteration: the probe alone.
    stats = [{"solver_path": "sparse", "topk": 24, "sinkhorn_iters_run": 5},
             {"solver_path": "sparse", "topk": 24, "sinkhorn_iters_run": 1}]
    run = traced({"col_kernel<true, true>": (2e-3, 6),
                  "col_combine_kernel": (1e-4, 6),
                  "row_matvec_kernel": (1e-4, 1),
                  "dense_col_kernel<true, 4, true>": (9.0, 1)}, stats)
    it = counts.least_seconds(*counts.masked_iteration_work(100_000, 1000,
                                                            24))
    row = counts.least_seconds(*counts.masked_row_work(100_000, 1000, 24))
    got = harness.reader("masked_sinkhorn_roofline")(run)
    assert got == pytest.approx(100.0 * (6 * it + row) / 2.2e-3)


@pytest.mark.parametrize("name", ["select_roofline",
                                  "masked_sinkhorn_roofline"])
def test_top_k_readers_find_nothing_on_the_dense_tier(name):
    stats = [{"solver_path": "dense", "sinkhorn_iters_run": 10}]
    run = traced({"dense_col_kernel<true, 4, true>": (1e-3, 10)}, stats)
    assert harness.reader(name)(run) is None
    assert harness.reader(name)(SimpleNamespace(trace=None)) is None


def test_implied_load_roofline_counts_each_load_once_on_a_mesh():
    # 10 loads: 10 launches on one card, 40 on four (each card its share).
    def run(cards, launches):
        return SimpleNamespace(
            trace=Summary(window_s=1.0, busy_s=0.5,
                          kernels={"load_kernel": (1e-4, launches)},
                          idle_by_host={}),
            launches={"implied_load": launches}, n=100_000, m=1000,
            entries=100_000, cards=cards)

    read = harness.reader("implied_load_roofline")
    need = 10 * counts.least_seconds(*counts.implied_load_work(
        100_000, 1000, 100_000))
    assert read(run(1, 10)) == pytest.approx(100.0 * need / 1e-4)
    assert read(run(4, 40)) == pytest.approx(read(run(1, 10)))
