#!/usr/bin/env python3
"""How far a batched or fused predict on the card is from a solo one.

    python3 tools/batch_parity.py [--payloads N] [--blas cublas|cublaslt]
                                  [--device cuda:0|cpu]

For each row-independent spec of ``chip_smoke.MODEL_SPECS``, builds the
model on cuda:0 and, for N seeded one-row payloads, compares the solo
answer (the store's one-row call) with the same row answered inside a
row-concatenated batch of 2-32 rows (zero padding, or other payloads'
rows) and inside a fused group of 2 and 8 models. Each error is
max|got - solo| / max|solo|, the measure ``chip_smoke.check_close``
holds against ``MODEL_TOL``. For the first payload it also replays one
8-row batch op by op (the family's ``_mm``/``_add``/``_layer_norm`` and
``torch.softmax``) and names the first op whose output for row 0 is not
bitwise the solo one's. Prints the card line and one JSON object; exits
non-zero without a CUDA device.

The port turns cuBLAS's workspace off on import (``CUBLAS_WORKSPACE_CONFIG``
``:0:0``, so no split-K) unless the variable is set: run it with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` to see the products with a workspace,
and ``--blas cublaslt`` for the other backend.
"""

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCHES = (2, 4, 8, 16, 32)
FUSED = (2, 8)


def rel_err(got, want) -> float:
    import numpy as np

    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


@contextlib.contextmanager
def op_trace(tf, torch, log: list):
    """Record row 0 of every traced op's output, in call order."""
    names = ("_mm", "_add", "_layer_norm")
    saved = {n: getattr(tf, n) for n in names}
    softmax = torch.softmax

    def wrap(name, fn):
        def traced(*a, **k):
            out = fn(*a, **k)
            log.append((name, out[0].detach().float().cpu().numpy().copy()))
            return out
        return traced

    for n in names:
        setattr(tf, n, wrap(n, saved[n]))
    torch.softmax = wrap("softmax", softmax)
    try:
        yield
    finally:
        for n in names:
            setattr(tf, n, saved[n])
        torch.softmax = softmax


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--payloads", type=int, default=16)
    ap.add_argument("--blas", default="")
    ap.add_argument("--device", default="cuda:0",
                    help="cpu rehearses the script without the card")
    args = ap.parse_args(argv[1:])
    import numpy as np
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("batch_parity: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from modelmesh_tpu_torch.models import families as tf
    from modelmesh_tpu_torch.models.server import TorchModelStore

    if args.blas:
        torch.backends.cuda.preferred_blas_library(args.blas)
    if dev.type == "cuda":
        print(cs.card_line(), flush=True)
    out = {"blas": args.blas or "default",
           "cublas_workspace_config":
               os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
           "specs": {}}
    for mtype, path in cs.MODEL_SPECS:
        model = tf.build_model("m-0", mtype, path, device=dev)
        if not model.batch_safe:
            continue
        pls = [cs.model_input(model, 1, cs.SEED + i)
               for i in range(args.payloads)]
        solos = [model.run(p) for p in pls]
        res = {"pad": {}, "mix": {}, "fused": {}}
        for b in BATCHES:
            pad, mix = [], []
            for i, p in enumerate(pls):
                x = np.zeros((b, *model.input_shape), model.input_dtype)
                x[0] = p[0]
                pad.append(rel_err(model.run(x)[:1], solos[i]))
                for j in range(1, b):
                    x[j] = pls[(i + j) % len(pls)][0]
                mix.append(rel_err(model.run(x)[:1], solos[i]))
            res["pad"][b] = {"max": max(pad), "bitwise": pad.count(0.0)}
            res["mix"][b] = {"max": max(mix), "bitwise": mix.count(0.0)}
        store = TorchModelStore(1 << 30, device=dev)
        mids = [f"m-f{g}" for g in range(max(FUSED))]
        for mid in mids:
            store.load(mid, mtype, path)
        fsolo = {mid: [np.frombuffer(store.predict_batch([(mid, p.tobytes())])
                                     [0], np.float32) for p in pls]
                 for mid in mids}
        for k in FUSED:
            errs = []
            for i, p in enumerate(pls):
                got = store.predict_batch([(mid, p.tobytes())
                                           for mid in mids[:k]])
                errs += [rel_err(np.frombuffer(g, np.float32), fsolo[m][i])
                         for g, m in zip(got, mids)]
            res["fused"][k] = {"max": max(errs), "bitwise": errs.count(0.0),
                               "of": len(errs)}
        res["fused_dispatches"] = store.fused_dispatches
        solo_log, batch_log = [], []
        with op_trace(tf, torch, solo_log):
            model.run(pls[0])
        x = np.stack([p[0] for p in pls[:8]])
        with op_trace(tf, torch, batch_log):
            model.run(x)
        first, differing = None, 0
        for k, ((name, a), (_, b)) in enumerate(zip(solo_log, batch_log)):
            if a.shape != b.shape:
                continue
            if not np.array_equal(a, b):
                differing += 1
                if first is None:
                    first = {"op": k, "name": name, "shape": list(a.shape),
                             "rel_err": rel_err(b, a)}
        res["trace"] = {"ops": len(solo_log), "differing": differing,
                        "first": first}
        out["specs"][path] = res
        print(json.dumps({path: res}), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
