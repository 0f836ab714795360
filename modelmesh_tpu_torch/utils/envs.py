"""Registry of the environment knobs the port reads.

The port's own copy of the reference registry's accessors, holding only
the knobs the port reads: the placement solve's and the model runtime's. ``get`` raises ``KeyError``
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
    kind: str          # str | int | float | bool
    default: str
    help: str
    consumer: str      # module that reads it


_ENGINE = "placement/torch_engine.py"
_SERVER = "models/server.py"

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
               "rounding noise generator: hash | threefry (JAX's PRNG; "
               "routes the solve to the dense tier)",
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
        # The model runtime's knobs, with the reference's defaults.
        EnvVar("MM_FUSED_DISPATCH", "bool", "1",
               "fused cross-model dispatch on the model runtime: "
               "co-located same-architecture models of a layer-streamable "
               "family share one batch group and execute a multi-model "
               "micro-batch as ONE stacked (vmapped) call, falling back "
               "per-model when the group's membership moved", _SERVER),
        EnvVar("MM_TRANSFER_CHUNK_BYTES", "int", str(1 << 20),
               "weight-transfer chunk granularity (bytes per chunk), read "
               "by the exporting loader's serializer", _SERVER),
        EnvVar("MM_SHARDED_MESH_DEVICES", "int", "0",
               "serving-mesh width for sharded execution "
               "(parallel/mesh.py serving_mesh): weight matrices are "
               "column-split across the first this many of the store's "
               "devices; 0 (default) = every one of them",
               "parallel/mesh.py"),
        EnvVar("MM_MAX_MSG_BYTES", "int", str(16 << 20),
               "gRPC message cap on every server/channel",
               "utils/grpcopts.py"),
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


def get_bool(name: str) -> bool:
    """Boolean knob: accepts 1/0, true/false, yes/no, on/off (any case).
    Junk raises — a silently-disabled opt-in is the failure mode this
    registry exists to prevent."""
    raw = str(os.environ.get(name, REGISTRY[name].default)).strip().lower()
    if raw in ("1", "true", "yes", "on"):
        return True
    if raw in ("0", "false", "no", "off", ""):
        return False
    raise ValueError(f"{name}={raw!r} is not a boolean")
