#!/usr/bin/env python3
"""Per-solve times of one checkout's main and dense_main phases on one GPU.

    cd ROOT && python3 /path/to/tools/solve_times.py

Runs the ``main`` (sparse) and ``dense_main`` (MM_SOLVER_SPARSE=0) phases
of the ``chip_smoke.py`` in the current directory, with that checkout's
package, at 100,000 models x 1,000 instances, and prints one JSON line of
their medians, device-inclusive ``solve_ms``, host ``extract_ms`` and host
syncs per solve. Run it in an older commit unpacked with ``git archive``
and in this one, in turns in one call (parent, change, change, parent), to
compare the two trees end to end on one card.
"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
dev = torch.device("cuda", 0)
cs._build.build_all()
t0 = time.perf_counter()
cols = cs.steady_fleet(*cs.MAIN_FLEET)
cs.time_top_k = lambda d: {}
m = cs.phase_main(dev, cols, time.perf_counter() - t0)
with cs.dense_pin():
    d = cs.phase_dense_main(dev, cols)
print(json.dumps({"e2e": os.getcwd(), "main_median": m["solve_ms_median"], "main_solve_ms": m["device_solve_ms"],
                  "main_extract_ms": m["extract_ms"], "dense_median": d["solve_ms_median"],
                  "dense_solve_ms": d["device_solve_ms"], "dense_extract_ms": d["extract_ms"],
                  "main_syncs": m["host_syncs_per_solve"], "dense_syncs": d["host_syncs_per_solve"]}), flush=True)
