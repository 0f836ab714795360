"""Carrying solver state across from the JAX package.

This system has no weights: its state is the problem snapshot and the
warm-start carries. These helpers take that state as plain numpy (what
``jax.device_get`` or ``np.asarray`` gives on the JAX side) and build the
port's containers from it, so both packages can solve the same problem.
bf16 arrays pass through f32, which holds every bf16 value exactly.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from modelmesh_tpu_torch.device import resolve_device
from modelmesh_tpu_torch.ops.costs import PlacementProblem
from modelmesh_tpu_torch.ops.solve import SolveInit
from modelmesh_tpu_torch.placement.torch_engine import ProblemColumns


def columns_from_numpy(src) -> ProblemColumns:
    """The port's ProblemColumns from the fields of a JAX ProblemColumns
    (numpy arrays and id lists), copied."""
    return ProblemColumns(**{
        name: list(v) if name.endswith("_ids") else np.array(v)
        for name, v in ((n, getattr(src, n)) for n in ProblemColumns._fields)
    })


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device).to(
            torch.bfloat16
        )
    return torch.from_numpy(np.array(a)).to(device)


def problem_from_numpy(leaves: Mapping, device=None) -> PlacementProblem:
    """The port's PlacementProblem on ``device`` from a JAX
    PlacementProblem's leaves as numpy, by field name."""
    dev = resolve_device(device)
    return PlacementProblem(**{
        name: _tensor(leaves[name], dev)
        for name in PlacementProblem.__dataclass_fields__
    })


def init_from_numpy(g0, price0=None, device=None) -> SolveInit:
    """A SolveInit warm-start carry from numpy column potentials/prices."""
    dev = resolve_device(device)
    return SolveInit(
        g0=_tensor(np.asarray(g0, np.float32), dev),
        price0=None if price0 is None else _tensor(
            np.asarray(price0, np.float32), dev
        ),
    )
