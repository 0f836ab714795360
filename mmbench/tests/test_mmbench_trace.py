"""The trace's reduction on synthetic events: on several cards a card's
idle share is its own, and ``device_idle_pct`` reads their mean, not the
union's; on one card the reduction reads as before."""

from types import SimpleNamespace

import pytest

from mmbench import harness
from mmbench.trace import reduce

MS = 1_000_000   # ns
SPANS = [("mmbench.window", 0, 100 * MS),
         ("mmbench.refresh", 10 * MS, 90 * MS)]
STATS = [{"snapshot_ms": 30.0, "dispatch_ms": 30.0}]


def idle_pct(summary):
    return harness.reader("device_idle_pct")(SimpleNamespace(trace=summary))


def test_two_cards_read_the_mean_of_their_idle_shares():
    # Card 0 busy 20-60 ms, card 1 busy 40-80 ms: each idle 60% of the
    # window; the union of both (20-80 ms) would read 40% idle.
    device = [("k0", 0, 20 * MS, 50 * MS), ("k0", 0, 45 * MS, 60 * MS),
              ("k1", 1, 40 * MS, 80 * MS)]
    s = reduce(device, SPANS, STATS, cards=2)
    assert s.busy == pytest.approx((0.040, 0.040))
    assert s.busy_s == pytest.approx(0.040)
    assert idle_pct(s) == pytest.approx(60.0)
    # Idle seconds by host stage, summed over the cards: card 0 idles
    # 0-20 (10 of it between spans, 10 in the snapshot) and 60-100 (the
    # dispatch until 70, the rest of the refresh until 90, then between);
    # card 1 idles 0-40 and 80-100.
    assert s.idle_by_host == pytest.approx({
        "between": 0.010 + 0.010 + 0.010 + 0.010,
        "refresh.snapshot": 0.010 + 0.030,
        "refresh.dispatch": 0.010,
        "refresh.other": 0.020 + 0.010,
    })
    assert s.kernels["k0"] == pytest.approx((0.045, 2))


def test_one_card_reads_the_union_as_before():
    # One card: every interval is the card's, whatever index it carries.
    device = [("k0", 0, 20 * MS, 50 * MS), ("k1", 3, 40 * MS, 80 * MS)]
    s = reduce(device, SPANS, STATS, cards=1)
    assert s.busy == pytest.approx((0.060,))
    assert s.busy_s == pytest.approx(0.060)
    assert idle_pct(s) == pytest.approx(40.0)
    assert sum(s.idle_by_host.values()) == pytest.approx(0.040)


def test_a_card_with_no_work_counts_as_idle():
    device = [("k0", 0, 0, 100 * MS)]
    s = reduce(device, SPANS, STATS, cards=4)
    assert s.busy == pytest.approx((0.1, 0.0, 0.0, 0.0))
    assert idle_pct(s) == pytest.approx(75.0)
