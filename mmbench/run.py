"""Run one cell of the benchmark and print its result.

    python3 mmbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The last line of standard output is the
result object; the numbers the check compared, each beside its limit,
are the last lines of standard error. No result is printed, and the exit
code is not 0, without the CUDA cards the cell asks for, when a module
of JAX or of the JAX package was loaded, or when the program is missing.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    try:
        from mmbench import harness
    except ImportError as exc:
        log(f"mmbench: cannot load the harness: {exc!r}")
        return 4
    try:
        result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START, log=log)
    except (harness.NoDevice, harness.Forbidden) as exc:
        log(f"mmbench: {exc}")
        return 3
    except ImportError as exc:
        log(f"mmbench: cannot run without the program: {exc!r}")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
