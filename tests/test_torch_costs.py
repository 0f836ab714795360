"""The port's cost assembly (modelmesh_tpu_torch/ops/costs.py) against the
JAX package's ``assemble_cost`` on the same problem, carried across as
numpy (modelmesh_tpu_torch/carry.py).

f32: allclose at atol 1e-5 (``sizes @ loaded`` is a matrix-vector product
whose summation order differs from XLA's). bf16: the f32 values round to
the same bf16 almost everywhere; where an f32 difference straddles a
rounding boundary the two differ by one bf16 ulp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu import ops
from modelmesh_tpu.ops.costs import assemble_cost as jax_assemble_cost
from modelmesh_tpu_torch.carry import problem_from_numpy
from modelmesh_tpu_torch.ops import costs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and
    PyTorch's default of one thread per core would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(n, m, seed, feasible_frac=1.0, zones=None):
    """A reference random_problem with a random loaded placement (the
    generator leaves it empty, which would zero the move and zone terms)
    and optionally explicit zone ids."""
    p = ops.random_problem(
        jax.random.PRNGKey(seed), n, m, capacity_slack=1.5,
        feasible_frac=feasible_frac,
    )
    rng = np.random.default_rng(seed)
    loaded = rng.random((n, m)) < 0.05
    zone = np.asarray(p.zone) if zones is None else np.asarray(zones, np.int32)
    p = dataclasses.replace(p, loaded=jnp.asarray(loaded),
                            zone=jnp.asarray(zone))
    leaves = {f.name: np.asarray(getattr(p, f.name))
              for f in dataclasses.fields(p)}
    return p, problem_from_numpy(leaves, device="cpu")


CASES = [
    (256, 512, 0, 1.0),
    (300, 200, 1, 0.5),
    (130, 1100, 2, 1.0),
    (512, 96, 3, 0.7),
]


@pytest.mark.parametrize("n,m,seed,frac", CASES)
def test_f32_allclose(n, m, seed, frac):
    jp, tp = _problem(n, m, seed, frac)
    want = np.asarray(jax_assemble_cost(jp, dtype=jnp.float32))
    got = costs.assemble_cost(tp, dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,m,seed,frac", CASES)
def test_bf16_equal_or_one_ulp(n, m, seed, frac):
    jp, tp = _problem(n, m, seed, frac)
    want = np.asarray(jax_assemble_cost(jp).astype(jnp.float32))
    got = costs.assemble_cost(tp).to(torch.float32).numpy()
    equal = got == want
    assert equal.mean() >= 0.999, equal.mean()
    # One bf16 ulp at the value's binade: 2**(exponent - 7).
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want)[~equal] <= ulp[~equal])


def test_out_of_range_zone_ids_get_no_crowding():
    """Zone ids outside [0, num_zones) one-hot to nothing in the reference;
    the port must force their crowding term to the same 0."""
    n, m = 64, 96
    zones = np.arange(m) % 11 - 1          # -1 .. 9, num_zones = 8
    jp, tp = _problem(n, m, 4, zones=zones)
    want = np.asarray(jax_assemble_cost(jp, dtype=jnp.float32))
    got = costs.assemble_cost(tp, dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_minmax_norm():
    x = torch.tensor([3.0, 1.0, 2.0])
    assert costs._minmax_norm(x).tolist() == [1.0, 0.0, 0.5]
    assert costs._minmax_norm(torch.full((4,), 7.0)).tolist() == [0.0] * 4


def test_problem_from_numpy_keeps_dtypes():
    jp, tp = _problem(64, 96, 5)
    assert tp.sizes.dtype == torch.float32
    assert tp.copies.dtype == torch.int32
    assert tp.loaded.dtype == torch.bool
    assert (tp.num_models, tp.num_instances) == (64, 96)
    np.testing.assert_array_equal(tp.copies.numpy(), np.asarray(jp.copies))
