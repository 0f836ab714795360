"""Synthetic cluster state for benchmarks and scale tests.

The same workload as the JAX package's ``placement/synthetic.py``: the
same numpy seed gives the same fleet (n models across ``types`` model
types with uniform sizes in [16, 256), every ``loaded_every``-th model
pre-loaded on a random instance, m instances over three zones).
"""

from __future__ import annotations

import numpy as np

from modelmesh_tpu_torch.records import InstanceRecord, ModelRecord


def synthetic_records(
    n: int,
    m: int,
    *,
    capacity_units: int = 50_000,
    loaded_every: int = 3,
    types: int = 8,
    seed: int = 7,
):
    """Returns (models, instances) as (id, record) tuple lists — the same
    shape registry/instance snapshots have at a refresh site."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(16, 256, n)
    loaded_on = rng.integers(0, m, n)
    models = []
    for i in range(n):
        mr = ModelRecord(
            model_type=f"t{i % types}", size_units=int(sizes[i]),
            last_used=1_000_000 + i,
        )
        if loaded_every and i % loaded_every == 0:
            mr.instance_ids[f"i{loaded_on[i]}"] = 1
        models.append((f"m{i}", mr))
    instances = [
        (f"i{j}", InstanceRecord(
            capacity_units=capacity_units, used_units=500, zone=f"z{j % 3}",
            lru_ts=1_000, req_per_minute=int(j % 60),
        ))
        for j in range(m)
    ]
    return models, instances
