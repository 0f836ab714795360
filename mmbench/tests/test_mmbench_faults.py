"""A run with the timed path broken underneath comes out not correct,
once for each fault a rebalance cell can have; the sound program comes
out correct. On the CPU, the program's plain versions, a small fleet."""

import pytest

from mmbench_runs import NoPriceSteps, Wrapped, cpu_run, wrapped


class Unchanged(Wrapped):
    """A step that returns its state unchanged: every refresh after
    set-up (the cold refresh and two warm ones) returns set-up's last
    plan."""

    frozen = None

    def refresh(self, *args, **kwargs):
        if self.frozen is not None:
            return self.frozen
        plan = super().refresh(*args, **kwargs)
        if self.calls == 3:
            self.frozen = plan
        return plan


class HalfTheTick(Wrapped):
    """Half of the batch left out: every other changed model and pod of a
    tick is not marked dirty, so its record stays stale in the columns."""

    def mark_dirty(self, models=(), instances=()):
        self.inner.mark_dirty(list(models)[::2], list(instances)[::2])


class AlteredAnswer(Wrapped):
    """An answer altered where it is produced: one model's pod in each
    plan is moved to the pod half the fleet away."""

    def refresh(self, *args, **kwargs):
        plan = super().refresh(*args, **kwargs)
        pods = self.fleet.pod_ids
        mid = self.fleet.model_ids[self.calls % len(self.fleet.model_ids)]
        j = pods.index(plan.placements[mid][0])
        plan.placements[mid] = [pods[(j + len(pods) // 2) % len(pods)]]
        return plan


def test_sound_program_is_correct():
    res = cpu_run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault", [Unchanged, HalfTheTick, AlteredAnswer,
                                   NoPriceSteps], ids=lambda c: c.__name__)
def test_fault_is_not_correct(fault):
    res = cpu_run(sut=wrapped(fault))
    assert not res["correct"], res["checks"]


def test_no_price_steps_fails_the_auction_comparison():
    res = cpu_run(sut=wrapped(NoPriceSteps))
    gap = res["checks"]["price_gap"]
    assert gap["value"] > gap["limit"], res["checks"]
