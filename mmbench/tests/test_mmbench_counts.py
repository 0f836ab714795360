"""The work counts and peaks of the rooflines."""

import pytest

from mmbench import counts


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
