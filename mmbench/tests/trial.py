"""Trial runs of the harness on the card (or cards): a cell, or a
configuration that no cell names on a cell's traffic; with the program
as a cell runs it, the control (the reference in the program's place,
with its cost and plan logits in fp8, below the configurations' bf16),
or the program with a fault planted in its top-K tier. The benchmark's
own runs never run it.

    python3 mmbench/tests/trial.py --seeds 1,2 \
        [--workload full-100k-1k.rebalance] [--config <file>.json] \
        [--seconds 51] [--chips 4] [--trace 1] \
        [--sut program|control|wider_gather|early_gate|no_price_steps|\
dropped_partial] [--digest] [--device cpu --scale 2048,256]

Each run goes through ``harness.run``, in this process, one after
another, and prints one JSON line: the seed, what ran, ``correct``, the
end-to-end metrics (with ``--trace 1`` every per-layer metric whose
reader finds something, those no cell lists too, and the breakdown), the
device, the compared numbers and, with ``--digest``, a digest of each
set-up refresh's plan (its placements and both carries), so that runs on
one card and on a mesh can be held to the same bytes. The harness's own
log line goes to standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
# Readers of the top-K tier that no cell lists yet.
EXTRA = (("select_roofline", "%"), ("masked_sinkhorn_roofline", "%"))


def digest(plan, model_ids, pod_ids) -> str:
    h = hashlib.sha256()
    h.update(json.dumps([plan.placements.get(m) for m in model_ids])
             .encode())
    for carry in (plan.warm_g, plan.warm_price):
        h.update(json.dumps([None if carry is None else carry.get(p)
                             for p in pod_ids]).encode())
    return h.hexdigest()[:16]


def card_peaks(device, chips: int) -> list:
    """Each card's peak of allocated bytes (none on the CPU)."""
    import torch

    if device is not None or not torch.cuda.is_available():
        return []
    return [torch.cuda.max_memory_allocated(i) for i in range(chips)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="full-100k-1k.rebalance")
    ap.add_argument("--config", default=None,
                    help="a configuration file in place of the cell's own")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--chips", type=int, default=None,
                    help="cards in place of the cell's")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sut", default="program",
                    choices=("program", "control", "wider_gather",
                             "early_gate", "no_price_steps",
                             "dropped_partial"))
    ap.add_argument("--dtype", default="float8_e4m3fn",
                    help="the control's precision")
    ap.add_argument("--digest", action="store_true")
    ap.add_argument("--device", default=None,
                    help="a device for every shard in place of the cards "
                         "(a rehearsal on the CPU)")
    ap.add_argument("--scale", default=None,
                    help="models,pods in place of the configuration's")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(HERE)]
    import torch

    import mmbench_runs as runs
    from mmbench import harness
    from mmbench.stand_in import StandIn

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, wl, cfg, _ = harness.load(ROOT, args.workload, args.config)
    chips = args.chips or int(wl["chips"])
    metrics = [(m["name"], m["unit"])
               for m in bench["per_layer" if args.trace else "end_to_end"]]
    if args.trace:
        metrics += list(EXTRA)
    scale = (None if args.scale is None
             else tuple(int(x) for x in args.scale.split(",")))
    patches = {"wider_gather": runs.wider_gather,
               "early_gate": runs.early_gate,
               "dropped_partial": runs.dropped_partial}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        digests = []

        def make(fleet, solver, clock, device):
            if args.sut == "control":
                return StandIn(fleet, solver, clock, device,
                               dtype=getattr(torch, args.dtype))
            system = harness.program(
                harness.cards(chips, args.device), cfg)
            if args.sut == "no_price_steps":     # eta 0 on the strategy
                runs.NoPriceSteps(system, fleet)
            if not args.digest:
                return system
            refresh = system.refresh

            def kept(*a, **kw):
                plan = refresh(*a, **kw)
                if len(digests) < 3:
                    digests.append(digest(plan, fleet.model_ids,
                                          fleet.pod_ids))
                return plan

            system.refresh = kept
            return system

        patch = patches.get(args.sut, contextlib.nullcontext)
        if args.device is None and torch.cuda.is_initialized():
            for card in range(chips):    # each run's peaks its own
                torch.cuda.reset_peak_memory_stats(card)
        t0 = time.perf_counter()
        try:
            with patch():
                res = harness.run(
                    ROOT, args.workload, seed, args.seconds,
                    bool(args.trace),
                    t_start=t0 if i else T_START, sut=make,
                    config=args.config, chips=chips,
                    metrics=metrics, device=args.device, scale=scale,
                    log=lambda line: print(line, file=sys.stderr,
                                           flush=True))
        except Exception as exc:  # noqa: BLE001 — the finding is the failure
            print(json.dumps({
                "config": cfg["name"], "seed": seed, "sut": args.sut,
                "chips": chips, "error": repr(exc)[:2000],
                "where": "".join(traceback.format_exception(exc)[-6:]),
                "card_peaks": card_peaks(args.device, chips),
                "run_s": time.perf_counter() - t0}), flush=True)
            return 1
        print(json.dumps({"config": cfg["name"], "seed": seed,
                          "sut": args.sut, "chips": chips,
                          "trace": args.trace, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "metrics": {k: v["value"]
                                      for k, v in res["metrics"].items()},
                          "device": res["device"],
                          "checks": {k: v["value"]
                                     for k, v in res["checks"].items()},
                          "breakdown": res.get("breakdown"),
                          "digests": digests,
                          "run_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
