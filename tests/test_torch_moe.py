"""The port's mixture-of-experts FFN (``parallel/moe.py``) and MoE
transformer (``models/families.py``, ``experts=E``) against the JAX
package's, on the CPU.

- ``init_moe_params`` byte for byte against ``jax.random`` on three seeds
  (f32 router, bf16 experts divided by a weak Python float).
- ``_route`` and ``reference_moe`` at ``tests/test_moe.py``'s sizes (D=32,
  FF=64, E=16, 256 tokens) with ``n_dev`` 1 and 4 and a tight capacity:
  dispatch (expert, slot and keep) and drops exactly equal, gates and
  outputs within ``FORWARD_TOL["transformer"]``.
- The MoE transformer: initial weights byte for byte; each MoE layer's
  routing exactly equal when the port's ``reference_moe`` is given the
  reference's own activations at that layer; and the end-to-end logits.
  End to end, the router's input carries the transformer's bf16-level
  drift (XLA-CPU against PyTorch-CPU), so a token whose top two
  probabilities nearly tie may take the other expert. Where every layer
  routes alike the logits are held at ``FORWARD_TOL``; where a layer
  differs, every differing token of the first such layer must have a
  reference top-2 margin below ``TIE_MARGIN``, and the case is not
  compared further (a flip sends the token through another expert).
- ``tests/test_models.py``'s spec error and ``ep=1`` on one device.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu.models import families as jf
from modelmesh_tpu.parallel import moe as jmoe
from modelmesh_tpu_torch import random as prng
from modelmesh_tpu_torch.models import families as tf
from modelmesh_tpu_torch.parallel import moe as tmoe

D, FF, E = 32, 64, 16
# The transformer's tolerance (tests/test_torch_models.py::FORWARD_TOL):
# (rtol, atol / max|ref|).
RTOL, ATOL_FRAC = 1e-2, 1e-2
# A routing difference end to end must start at a near-tie.
TIE_MARGIN = 1e-3
MOE_SPECS = [
    "transformer://experts=8",
    "transformer://d=64,heads=4,seq=64,layers=2,experts=16,groups=8",
    "transformer://vocab=64,d=32,layers=1,heads=2,seq=8,experts=4",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _params(seed: int):
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), D, FF, E)
    return jp, {k: _to_torch(v) for k, v in jp.items()}


def _tokens(seed: int, n: int = 256) -> np.ndarray:
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (n, D),
                                      jnp.float32))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_FRAC * np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 2, 4])
def test_init_moe_params_byte_identical(seed):
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), D, FF, E)
    tp = tmoe.init_moe_params(prng.PRNGKey(seed), D, FF, E)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k
        assert str(jp[k].dtype) == str(tp[k].dtype).removeprefix("torch."), k
        assert np.asarray(jp[k]).tobytes() == tf.leaf_bytes(tp[k]), k
    assert tp["router"].dtype == torch.float32
    assert tp["w_in"].dtype == tp["w_out"].dtype == torch.bfloat16


@pytest.mark.parametrize("n_dev", [1, 4])
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_route_matches_reference(n_dev, factor):
    jp, tp = _params(0)
    x = _tokens(1)[: 256 // n_dev]
    cap = max(1, math.ceil(x.shape[0] * factor / E))
    jd, jg = jmoe._route(jnp.asarray(x), jp["router"], E, cap)
    td, tg = tmoe._route(torch.from_numpy(x), tp["router"], E, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    _close(tg, jg)
    if factor < 1:
        assert 0 < (td.numpy().sum((1, 2)) == 0).mean() < 0.9   # drops


@pytest.mark.parametrize("n_dev", [1, 4])
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_reference_moe_matches_reference(n_dev, factor):
    jp, tp = _params(2)
    x = _tokens(3)
    want = jmoe.reference_moe(jp, jnp.asarray(x), E, factor, n_dev=n_dev)
    got = tmoe.reference_moe(tp, torch.from_numpy(x), E, factor,
                             n_dev=n_dev)
    assert got.dtype == torch.float32 and got.shape == want.shape
    # Dropped tokens are zero on both sides, exactly.
    np.testing.assert_array_equal(got.abs().sum(1).numpy() == 0,
                                  np.abs(np.asarray(want)).sum(1) == 0)
    _close(got, want)
    with pytest.raises(ValueError, match="divisible"):
        tmoe.reference_moe(tp, torch.zeros(250, D), E, n_dev=8)


def _record_routes(monkeypatch):
    """Record (dispatch, probs, x) of every ``_route`` call on both sides,
    in call order (the reference's through an ordered callback)."""
    jrec, trec = [], []
    jroute, troute = jmoe._route, tmoe._route

    def jax_route(x, router, n_experts, capacity):
        d, g = jroute(x, router, n_experts, capacity)
        probs = jax.nn.softmax(x.astype(jnp.float32) @ router, axis=-1)
        jax.debug.callback(
            lambda *a: jrec.append(tuple(np.asarray(v) for v in a)),
            d, probs, x, ordered=True)
        return d, g

    def torch_route(x, router, n_experts, capacity):
        d, g = troute(x, router, n_experts, capacity)
        trec.append((d.numpy(), None, None))
        return d, g

    monkeypatch.setattr(jmoe, "_route", jax_route)
    monkeypatch.setattr(tmoe, "_route", torch_route)
    return jrec, trec


def _models(path: str, mid: str):
    jm = jf.build_model(mid, "transformer", path)
    tm = tf.build_model(mid, "transformer", path, device="cpu")
    return jm, tm


@pytest.mark.parametrize("mid", ["m1", "other"])
@pytest.mark.parametrize("path", MOE_SPECS)
def test_moe_transformer_weights_byte_identical(path, mid):
    jm, tm = _models(path, mid)
    jl, tl = jax.tree.leaves(jm.params), tf.leaves(tm.params)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert tuple(a.shape) == tuple(b.shape), i
        assert np.asarray(a).tobytes() == tf.leaf_bytes(b), i
    assert tm.size_bytes == jm.size_bytes
    assert (tm.fuse_key, tm.batch_safe) == (jm.fuse_key, jm.batch_safe)
    assert tm.batch_safe is False
    assert "moe" in tm.params["blocks"][0]


@pytest.mark.parametrize("mid", ["m1", "m2", "other"])
@pytest.mark.parametrize("path", MOE_SPECS)
def test_moe_transformer_matches_reference(monkeypatch, path, mid):
    jm, tm = _models(path, mid)
    tm.params = tf.params_from_leaves(
        tm.params, [np.asarray(leaf) for leaf in jax.tree.leaves(jm.params)],
        device="cpu")
    jrec, trec = _record_routes(monkeypatch)
    n_experts = tm.params["blocks"][0]["moe"]["router"].shape[1]
    groups = jf.ModelSpec.parse("transformer", path).params.get("groups", 1)
    rng = np.random.default_rng(1)
    for n in (1, 4):
        x = rng.integers(-3, 5000, size=(n, *jm.input_shape)).astype(np.int32)
        jrec.clear()
        trec.clear()
        ref = np.asarray(jm.apply(jm.params, jnp.asarray(x)), np.float32)
        jax.effects_barrier()
        assert len(jrec) == len(tm.params["blocks"]) * groups
        # Each MoE layer on the reference's own activations: the port
        # routes every token alike.
        for i, blk in enumerate(tm.params["blocks"]):
            calls = jrec[i * groups:(i + 1) * groups]
            trec.clear()
            tmoe.reference_moe(
                blk["moe"], torch.from_numpy(np.concatenate(
                    [r[2] for r in calls])), n_experts, n_dev=groups)
            assert len(trec) == groups
            for (got_d, _, _), (want_d, _, _) in zip(trec, calls):
                np.testing.assert_array_equal(got_d, want_d)
        # End to end.
        trec.clear()
        got = tm.run(x)
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert len(trec) == len(jrec)
        differ = [k for k, (t, j) in enumerate(zip(trec, jrec))
                  if not np.array_equal(t[0], j[0])]
        if not differ:
            np.testing.assert_allclose(got, ref, rtol=RTOL,
                                       atol=ATOL_FRAC * np.abs(ref).max())
            continue
        first_layer = differ[0] // groups
        for k in range(first_layer * groups, (first_layer + 1) * groups):
            _, probs, _ = jrec[k]
            t_exp = trec[k][0].sum(2).argmax(1)
            j_exp = jrec[k][0].sum(2).argmax(1)
            kept = (trec[k][0].sum((1, 2)) > 0) & (jrec[k][0].sum((1, 2)) > 0)
            top2 = np.sort(probs, axis=-1)[:, -2:]
            for tok in np.nonzero(kept & (t_exp != j_exp))[0]:
                margin = float(top2[tok, 1] - top2[tok, 0])
                assert margin < TIE_MARGIN, (path, mid, n, k, tok, margin)


def test_groups_must_divide_seq():
    """``tests/test_models.py``: a non-dividing group count is a spec
    error at build time."""
    with pytest.raises(ValueError, match="groups=6 must divide"):
        tf.build_model(
            "moe-bad", "transformer",
            "transformer://d=64,heads=4,seq=64,layers=1,experts=8,groups=6",
            device="cpu")


def test_ep_on_one_device_is_the_dense_oracle():
    """``tests/test_models.py``'s ``ep=1`` case on one device: the same
    weights and the same function, bit for bit (both run
    ``reference_moe`` with ``groups`` shards); the output still moves with
    the input."""
    path = "transformer://d=64,heads=4,seq=64,layers=2,experts=16,groups=8"
    dense = tf.build_model("moe-model", "transformer", path, device="cpu")
    ep = tf.build_model("moe-model", "transformer", path + ",ep=1",
                        device="cpu")
    for a, b in zip(tf.leaves(dense.params), tf.leaves(ep.params)):
        assert tf.leaf_bytes(a) == tf.leaf_bytes(b)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 255, (2, 64)).astype(np.int32)
    a, b = dense.run(tokens), ep.run(tokens)
    np.testing.assert_array_equal(a, b)
    tokens2 = tokens.copy()
    tokens2[:, -1] ^= 1
    assert np.abs(ep.run(tokens2) - b).max() > 1e-3
