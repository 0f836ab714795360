"""The control's readings on the card: the reference put in the
program's place with its cost and plan logits in fp8 (``stand_in.py``),
judged as a run judges the program, at the cell's own size.

    python3 mmbench/control.py --workload <name> --seeds 1,2,3 \
        [--seconds 10] [--dtype float8_e4m3fn] [--config <file>]

Prints one JSON line of the compared numbers per seed. The benchmark's
own runs never run it; ``mmbench/tests/test_mmbench_control.py`` runs it
on the CPU at a test's size.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--dtype", default="float8_e4m3fn")
    ap.add_argument("--config", default=None,
                    help="a configuration file in place of the cell's own")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from mmbench import harness
    from mmbench.stand_in import StandIn

    dtype = getattr(torch, args.dtype)

    def make(fleet, solver, clock, device):
        return StandIn(fleet, solver, clock, device, dtype=dtype)

    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run(ROOT, args.workload, seed, args.seconds, False,
                          t_start=time.perf_counter(), sut=make,
                          config=args.config, log=lambda line: None)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
