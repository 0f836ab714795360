"""Phase ``cluster`` of ``chip_smoke.py`` alone, several times, with the
survivors stopped in a chosen order, to show what the stop order does to
the election.

    python3 tools/cluster_leader_order.py first,first,last,last [--out FILE]

Each word is one run of ``chip_smoke.phase_cluster``: ``first`` stops the
leader before the other survivor (a follower then outlives the leader,
is elected and may publish its own generation 1), ``last`` uses the
phase's own order (the leader last). The phase's JSON lines, among them
its ``cluster_leadership`` line (each pod's election turns and the
published ticks), go to ``--out`` (default: standard output); one
summary line a run, with the gate that failed, goes to standard error.
Needs one CUDA device; builds the kernels first.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def leader_first(survivors, leader):
    return [leader] + [p for p in survivors if p is not leader]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", help="comma-separated: first or last a run")
    ap.add_argument("--out", help="file for the phase's JSON lines")
    args = ap.parse_args()
    runs = args.runs.split(",")
    if not set(runs) <= {"first", "last"}:
        ap.error(f"runs must be first or last: {runs}")
    if not torch.cuda.is_available():
        print("cluster_leader_order: no CUDA device", file=sys.stderr)
        return 2
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        sys.stdout = open(args.out, "w")
    dev = torch.device("cuda", 0)
    cs.phase_build()
    card = cs.card_line()
    own_order = cs.cluster_stop_order
    for k, leader_stopped in enumerate(runs):
        cs.cluster_stop_order = (own_order if leader_stopped == "last"
                                 else leader_first)
        t = time.time()
        try:
            cs.phase_cluster(dev, card)
            result = "ok"
        except Exception as e:  # noqa: BLE001 — report and go on
            result = repr(e)
        line = json.dumps({"run": k, "leader_stopped": leader_stopped,
                           "result": result, "s": time.time() - t})
        print(line, flush=True)
        print(line, file=sys.stderr, flush=True)
    print(card, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
