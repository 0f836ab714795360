"""The port's expert-parallel MoE FFN (``modelmesh_tpu_torch/parallel/moe.py``
``make_expert_parallel_ffn``) on a mesh of 8 "cpu" shards, against its own
oracle and the JAX package's expert-parallel FFN on the 8 virtual CPU
devices.

- ``tests/test_moe.py``'s four cases on the port: the oracle at
  ``n_dev=8``, tight capacity (drops deterministic, two runs bit for bit),
  generous capacity (no drops), and the shape checks.
- The port's EP against the reference's EP on the same weights (the
  port's ``init_moe_params`` is byte for byte the reference's) and
  tokens, at ``FORWARD_TOL["transformer"]``, the tolerance
  ``tests/test_torch_moe.py`` holds ``reference_moe`` to, with the same
  tokens dropped.
- The port's EP against its own oracle: each shard's routing (every
  token's expert, slot and drop) equal to the oracle's group, outputs at
  rtol 1e-5; two ``all_to_all``s a call.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu.parallel import moe as jmoe
from modelmesh_tpu_torch import random as prng
from modelmesh_tpu_torch.models import families as tf
from modelmesh_tpu_torch.parallel import mesh as mesh_mod
from modelmesh_tpu_torch.parallel import moe as tmoe

N_DEV = 8
D, FF, E = 32, 64, 16
RTOL, ATOL_FRAC = 1e-2, 1e-2     # tests/test_torch_moe.py's


@pytest.fixture(scope="module")
def mesh():
    return tmoe.make_expert_mesh(["cpu"] * N_DEV)


@pytest.fixture(scope="module")
def jax_mesh():
    return jmoe.make_expert_mesh(jax.devices()[:N_DEV])


def _params(seed):
    return tmoe.init_moe_params(prng.PRNGKey(seed), D, FF, E)


def _tokens(seed, n=256):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(
        np.float32)


def test_sharded_matches_dense_oracle(mesh):
    params = _params(0)
    x = torch.from_numpy(_tokens(1))
    fn = tmoe.make_expert_parallel_ffn(mesh, E, capacity_factor=1.25)
    mesh.collectives.clear()
    got = fn(params, x)
    assert mesh.collectives == {"all_to_all": 2}
    assert got.dtype == torch.float32 and got.shape == x.shape
    want = tmoe.reference_moe(params, x, E, 1.25, n_dev=N_DEV)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-2,
                               rtol=2e-2)
    assert got.abs().max() > 0, "all tokens dropped: routing broken"


def test_capacity_drops_are_deterministic_and_bounded(mesh):
    params = _params(2)
    x = torch.from_numpy(_tokens(3))
    fn = tmoe.make_expert_parallel_ffn(mesh, E, capacity_factor=0.5)
    a, b = fn(params, x), fn(params, x)
    assert torch.equal(a, b)
    want = tmoe.reference_moe(params, x, E, 0.5, n_dev=N_DEV)
    np.testing.assert_allclose(a.numpy(), want.numpy(), atol=2e-2, rtol=2e-2)
    dropped = (a.abs().sum(1) == 0).float().mean().item()
    assert 0.0 < dropped < 0.9, f"drop fraction {dropped} implausible"


def test_generous_capacity_drops_nothing(mesh):
    params = _params(4)
    x = torch.from_numpy(_tokens(5, 128))
    fn = tmoe.make_expert_parallel_ffn(mesh, E, capacity_factor=float(E))
    assert (fn(params, x).abs().sum(1) > 0).all()


def test_shape_validation(mesh):
    params = _params(6)
    fn = tmoe.make_expert_parallel_ffn(mesh, E)
    with pytest.raises(ValueError, match="divisible"):
        fn(params, torch.zeros(250, D))          # 250 % 8 != 0
    with pytest.raises(ValueError, match="divisible"):
        tmoe.make_expert_parallel_ffn(mesh, 12)  # 12 % 8 != 0


@pytest.mark.parametrize("seed,factor", [(0, 1.25), (2, 0.5), (8, 2.0)])
def test_matches_reference_expert_parallel(mesh, jax_mesh, seed, factor):
    tp = _params(seed)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), D, FF, E)
    for k in jp:
        assert np.asarray(jp[k]).tobytes() == tf.leaf_bytes(tp[k]), k
    x = _tokens(seed + 1)
    got = tmoe.make_expert_parallel_ffn(mesh, E, factor)(
        tp, torch.from_numpy(x)).numpy()
    want = np.asarray(jmoe.make_expert_parallel_ffn(jax_mesh, E, factor)(
        jp, jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.abs(got).sum(1) == 0,
                                  np.abs(want).sum(1) == 0)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_FRAC * np.abs(want).max())
    # The same weights carried from the reference's leaves.
    carried = tmoe.make_expert_parallel_ffn(mesh, E, factor)(
        {k: torch.from_numpy(np.asarray(v).view(np.uint16).copy()).view(
            torch.bfloat16) if v.dtype == jnp.bfloat16
         else torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()},
        torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(carried, got)


def _recorded_routes(monkeypatch):
    """Every ``_route`` call's dispatch, keyed by the shard that made it
    (the oracle's calls by call order)."""
    rec, lock, route = {}, threading.Lock(), tmoe._route

    def recording(x, router, n_experts, capacity):
        d, g = route(x, router, n_experts, capacity)
        try:
            key = ("ep", mesh_mod.axis_index(tmoe.EXPERT_AXIS))
        except RuntimeError:
            key = ("oracle", sum(k[0] == "oracle" for k in rec))
        with lock:
            rec[key] = d.clone()
        return d, g

    monkeypatch.setattr(tmoe, "_route", recording)
    return rec


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_routing_and_outputs_equal_the_oracle(mesh, monkeypatch, factor):
    params = _params(10)
    x = torch.from_numpy(_tokens(11))
    rec = _recorded_routes(monkeypatch)
    got = tmoe.make_expert_parallel_ffn(mesh, E, factor)(params, x)
    want = tmoe.reference_moe(params, x, E, factor, n_dev=N_DEV)
    cap = max(1, math.ceil(256 // N_DEV * factor / E))
    for g in range(N_DEV):
        ep, oracle = rec[("ep", g)], rec[("oracle", g)]
        assert ep.shape == (256 // N_DEV, E, cap)
        assert torch.equal(ep, oracle), g
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


def test_bf16_tokens_come_back_bf16(mesh):
    params = _params(12)
    x = torch.from_numpy(_tokens(13, 64)).to(torch.bfloat16)
    got = tmoe.make_expert_parallel_ffn(mesh, E)(params, x)
    want = tmoe.reference_moe(params, x, E, n_dev=N_DEV)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=1e-2, atol=1e-2)


def test_experts_on_another_device_are_placed_once():
    """A shard on another device than the weights reads copies of its
    experts, made on the first call, reused, and dropped with the
    weights; a shard on their device reads views."""
    mesh = mesh_mod.Mesh(["cpu"] * 3 + ["meta"], (4,), (tmoe.EXPERT_AXIS,))
    place = tmoe._Placement(mesh, tmoe.EXPERT_AXIS, E // 4)
    params = _params(14)
    first = place(params)
    assert all(first[r][1].data_ptr() == params["w_in"][4 * r].data_ptr()
               for r in range(3))
    assert all(t.device.type == "meta" for t in first[3])
    again = place(params)
    assert again[3] is first[3] and len(place._copies) == 1
    del params, first, again
    assert place._copies == {}
