"""Registry of the environment knobs the port reads.

The port's own copy of the reference registry's accessors, holding only
the knobs of the placement solve. ``get`` raises ``KeyError``
for an unregistered name, so a typo'd knob fails at the call site instead
of silently reading the default.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class EnvVar:
    name: str
    kind: str          # str | int | float
    default: str
    help: str
    consumer: str      # module that reads it


_ENGINE = "placement/torch_engine.py"

REGISTRY: dict[str, EnvVar] = {
    e.name: e
    for e in [
        # MM_SOLVER_*: operator overrides of SolveConfig (empty = the
        # compiled default), read when a config is built from the env.
        EnvVar("MM_SOLVER_SINKHORN_ITERS", "int", "",
               "Sinkhorn iterations per solve (default 10)", _ENGINE),
        EnvVar("MM_SOLVER_AUCTION_ITERS", "int", "",
               "auction price-repair iterations (default 40)", _ENGINE),
        EnvVar("MM_SOLVER_TAU", "float", "",
               "Gumbel sampling temperature; 0 = deterministic argmax",
               _ENGINE),
        EnvVar("MM_SOLVER_LSE_IMPL", "str", "",
               "dense-tier Sinkhorn LSE kernels: auto (default — the CUDA "
               "kernels for CUDA tensors, their plain PyTorch versions "
               "for CPU tensors) | cuda (CUDA tensors required)", _ENGINE),
        EnvVar("MM_SOLVER_LOAD_IMPL", "str", "",
               "auction implied-load histogram: auto | scatter", _ENGINE),
        EnvVar("MM_SOLVER_NOISE_IMPL", "str", "",
               "rounding noise generator: hash (threefry is not ported)",
               _ENGINE),
        EnvVar("MM_SOLVER_FINAL_SELECT", "str", "",
               "auction epilogue selection: exact | approx | none",
               _ENGINE),
        EnvVar("MM_SOLVER_SINKHORN_TOL", "float", "",
               "Sinkhorn early-exit tolerance on relative L1 row-marginal "
               "error (0/unset = fixed iteration budget)", _ENGINE),
        EnvVar("MM_SOLVER_SINKHORN_CHUNK", "int", "",
               "iterations per Sinkhorn convergence check (default 4)",
               _ENGINE),
        EnvVar("MM_SOLVER_AUCTION_STALL_TOL", "float", "",
               "auction early-exit stall tolerance (0/unset = fixed "
               "budget)", _ENGINE),
        EnvVar("MM_SOLVER_SPARSE", "str", "",
               "sparse top-K solve path: auto (default), 1/on forces "
               "sparse, 0/off forces dense", _ENGINE),
        EnvVar("MM_SOLVER_TOPK", "int", "",
               "candidate instances gathered per model on the sparse path "
               "(default 24)", _ENGINE),
        EnvVar("MM_SOLVER_SPARSE_IMPL", "str", "",
               "sparse-path kernel backend: auto (default — the CUDA "
               "kernels for CUDA tensors, their plain PyTorch versions "
               "for CPU tensors) | cuda (CUDA tensors required)", _ENGINE),
        EnvVar("MM_SOLVER_INCREMENTAL_MAX_DIRTY_FRAC", "float", "0.05",
               "dirty-row fraction ceiling for the incremental re-solve "
               "(frozen column potentials/prices); above it — or when "
               "the merged overflow fails the quality gate — the refresh "
               "falls back to a full warm solve; 0 disables incremental",
               _ENGINE),
    ]
}


def get(name: str) -> Optional[str]:
    """Raw read; raises KeyError for unregistered names."""
    spec = REGISTRY[name]
    return os.environ.get(name, spec.default or None)


def get_int(name: str) -> int:
    spec = REGISTRY[name]
    if not spec.default and not os.environ.get(name):
        raise ValueError(f"{name} is unset and has no default")
    try:
        return int(os.environ.get(name, spec.default))
    except ValueError:
        return int(spec.default)


def get_float(name: str) -> float:
    spec = REGISTRY[name]
    if not spec.default and not os.environ.get(name):
        raise ValueError(f"{name} is unset and has no default")
    try:
        return float(os.environ.get(name, spec.default))
    except ValueError:
        return float(spec.default)
