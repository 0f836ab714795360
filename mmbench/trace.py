"""The device trace of a ``--trace 1`` run, reduced.

``torch.profiler`` records the window; ``Trace.summary`` reads its raw
events: the device's operations (kernels, copies, sets) as intervals,
and this benchmark's own host spans (``record_function`` ranges named
``mmbench.*``); ``reduce`` turns them into the summary. A card's busy
time is the union of its device intervals inside the window span, not
their sum; its idle time is split by what the host was doing then: the
span it was in, and inside a refresh the stage that ``plan.stats`` timed
(snapshot, dispatch, readback wait, extraction). On several cards each
card is reduced alone: the busy time reported is the cards' mean (so one
minus its share of the window is the mean of the cards' idle shares),
the idle time by host stage the cards' sum, and a kernel's device time
the sum over the cards. On one card every interval counts for it,
whatever device index the trace gives it.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import NamedTuple

import torch

WINDOW = "mmbench.window"
REFRESH = "mmbench.refresh"
STAGES = ("snapshot_ms", "dispatch_ms", "readback_wait_ms", "extract_ms")


class Summary(NamedTuple):
    window_s: float
    busy_s: float        # the cards' mean
    kernels: dict        # name -> (device seconds over the cards, count)
    idle_by_host: dict   # label -> idle seconds, summed over the cards
    busy: tuple = ()     # each card's busy seconds, by device index


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


def _short(name: str) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:80]


def kernel_matches(name: str, names) -> bool:
    """``name`` (a trace's kernel name) is one of ``names``, compared as
    a whole identifier (``col_kernel`` does not match ``col_kernelx``)."""
    return any(re.search(rf"(?<![A-Za-z0-9_]){re.escape(k)}(?![A-Za-z0-9_])",
                         name) for k in names)


class Trace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def summary(self, refresh_stats: list, cards: int = 1) -> Summary:
        """``refresh_stats``: each traced refresh's ``plan.stats``, in
        order (the stages' lengths); ``cards``: the run's cards (device
        indices ``0 .. cards - 1``)."""
        device, spans = [], []
        for e in self.prof.profiler.kineto_results.events():
            user = getattr(e, "is_user_annotation", lambda: False)()
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if user or name.startswith("mmbench."):
                    continue
                device.append((name, e.device_index(), _ns(e, "start"),
                               _ns(e, "end")))
            elif name.startswith("mmbench."):
                spans.append((name, _ns(e, "start"), _ns(e, "end")))
        return reduce(device, spans, refresh_stats, cards)


def reduce(device: list, spans: list, refresh_stats: list,
           cards: int = 1) -> Summary:
    """The summary of ``device`` intervals (name, device index, start ns,
    end ns) and ``spans`` (name, start ns, end ns) over the window span.
    On one card every interval is the card's; on several, an interval
    on a device index outside ``0 .. cards - 1`` counts only among the
    kernels."""
    windows = [s for s in spans if s[0] == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    _, w0, w1 = windows[0]
    inside = sorted((max(s, w0), min(t, w1), card if cards > 1 else 0, name)
                    for name, card, s, t in device if t > w0 and s < w1)
    kernels = defaultdict(lambda: [0.0, 0])
    for s, t, _, name in inside:
        k = kernels[_short(name)]
        k[0] += (t - s) / 1e9
        k[1] += 1
    labels = _host_labels(spans, refresh_stats)
    busy, idle = [], defaultdict(float)
    for card in range(cards):
        union, gaps = _union([(s, t) for s, t, c, _ in inside if c == card],
                             w0, w1)
        busy.append(union / 1e9)
        for label, secs in _split_gaps(gaps, labels).items():
            idle[label] += secs
    return Summary(
        window_s=(w1 - w0) / 1e9, busy_s=sum(busy) / len(busy),
        kernels={k: (v[0], v[1]) for k, v in kernels.items()},
        idle_by_host=dict(idle), busy=tuple(busy),
    )


def _union(intervals: list, w0: int, w1: int) -> tuple:
    """The length of the union of sorted ``intervals`` (start, end) and
    the gaps (start, end) it leaves in [w0, w1]."""
    union, gaps, cur_s, cur_t = 0, [], None, w0
    gap_from = w0
    for s, t in intervals:
        if cur_s is None or s > cur_t:
            if cur_s is not None:
                union += cur_t - cur_s
            if s > gap_from:
                gaps.append((gap_from, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
        gap_from = max(gap_from, cur_t)
    if cur_s is not None:
        union += cur_t - cur_s
    if w1 > gap_from:
        gaps.append((gap_from, w1))
    return union, gaps


def _host_labels(spans, refresh_stats) -> list:
    """(start, end, label) host intervals: the benchmark's spans, each
    refresh cut into the stages its stats timed (in order, from the
    span's start) and what is left of it."""
    out = []
    refreshes = sorted(s for s in spans if s[0] == REFRESH)
    for (_, s, t), stats in zip(refreshes, refresh_stats):
        at = s
        for stage in STAGES:
            ms = stats.get(stage)
            if ms is None:
                continue
            end = min(t, at + int(ms * 1e6))
            out.append((at, end, "refresh." + stage[:-3]))
            at = end
        out.append((at, t, "refresh.other"))
    for name, s, t in spans:
        if name not in (REFRESH, WINDOW):
            out.append((s, t, name[len("mmbench."):]))
    return sorted(out)


def _split_gaps(gaps, labels) -> dict:
    """Idle seconds by host label; time under no label is "between".
    The labels do not overlap, so each gap looks only at the labels that
    start before its end, from the last one that starts before it."""
    idle = defaultdict(float)
    starts = [s for s, _, _ in labels]
    for g0, g1 in gaps:
        covered = 0
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        while i < len(labels) and labels[i][0] < g1:
            s, t, label = labels[i]
            i += 1
            if t <= g0:
                continue
            part = min(t, g1) - max(s, g0)
            idle[label] += part / 1e9
            covered += part
        if g1 - g0 > covered:
            idle["between"] += (g1 - g0 - covered) / 1e9
    return dict(idle)
