"""The port's threefry PRNG (``modelmesh_tpu_torch/random.py``) against
``jax.random`` on the CPU.

Bitwise: ``PRNGKey``, ``split``, the 8-, 16- and 32-bit ``random_bits``,
``uniform`` in f32 and bf16 over several ranges, the bf16 ``normal`` (on
every one of the 128 values a bf16 uniform takes, too), the f32
``normal`` (XLA's erf_inv over XLA's CPU ``log1p``, which the port
reproduces: the MoE router draws it) and the uniforms under ``gumbel``;
at seeds 0, 7, the solver's int32 seeds (negative and 2**31 - 1), crc32
seeds above 2**31, and shapes with odd sizes.

Within a tolerance: ``gumbel`` (PyTorch's ``log`` against XLA's: 2e-4,
the tolerance of the port's hash Gumbel tests). The kernel
(``ops/cuda_random.py``) is held bitwise against this plain version on
the card by ``chip_smoke.py``; here its wrapper takes the plain route for
the CPU (the weight draw's ``normal`` too, bitwise ``jax.random.normal``)
and refuses other devices.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu_torch import random as prng
from modelmesh_tpu_torch.ops import cuda_random

SEEDS = [0, 7, -3, 2**31 - 1, zlib.crc32(b"m1"), zlib.crc32(b"model-z")]
SHAPES = [(7,), (33, 17), (4, 3, 5)]
GUMBEL_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def test_seeds_cover_the_solver_and_crc32_ranges():
    assert any(s < 0 for s in SEEDS)
    assert any(s > 2**31 for s in SEEDS)


@pytest.mark.parametrize("seed", SEEDS + [2**32 - 1, -(2**31)])
def test_prng_key(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(), want)


def test_prng_key_rejects_seeds_past_32_bits():
    with pytest.raises(OverflowError):
        prng.PRNGKey(2**32)
    with pytest.raises(OverflowError):
        prng.PRNGKey(-(2**31) - 1)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 14])
def test_split(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    got = prng.split(prng.PRNGKey(seed), num).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_split_of_a_split_key():
    jk = jax.random.split(jax.random.PRNGKey(5))[1]
    tk = prng.split(prng.PRNGKey(5))[1]
    np.testing.assert_array_equal(
        prng.split(tk, 4).numpy(),
        np.asarray(jax.random.split(jk, 4)).astype(np.int64),
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("width,dtype", [(32, jnp.uint32), (16, jnp.uint16),
                                         (8, jnp.uint8)])
def test_random_bits(seed, shape, width, dtype):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape, dtype))
    got = prng.random_bits(prng.PRNGKey(seed), width, shape, "cpu").numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,tdtype", [(jnp.float32, torch.float32),
                                          (jnp.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.0, 3.0), (0.3, 0.7)])
def test_uniform(seed, shape, dtype, tdtype, lo, hi):
    want = jax.random.uniform(jax.random.PRNGKey(seed), shape, dtype, lo, hi)
    got = prng.uniform(prng.PRNGKey(seed), shape, tdtype, lo, hi,
                       device="cpu")
    assert got.dtype == tdtype
    np.testing.assert_array_equal(_np(got), _jnp(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_normal_bf16_bitwise(seed, shape):
    want = jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.bfloat16)
    got = prng.normal(prng.PRNGKey(seed), shape, torch.bfloat16,
                      device="cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _jnp(want))


def test_normal_bf16_every_reachable_uniform():
    """A bf16 uniform has 7 random bits: 65,536 draws reach all 128 values
    (and so every input erf_inv sees), and each matches XLA's."""
    want = _jnp(jax.random.normal(jax.random.PRNGKey(11), (65536,),
                                  jnp.bfloat16))
    got = _np(prng.normal(prng.PRNGKey(11), (65536,), torch.bfloat16,
                          device="cpu"))
    assert len(np.unique(want)) == 128
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES + [(4096,)])
def test_normal_f32(seed, shape):
    """The uniform under it bitwise, and the values bitwise (the port
    reproduces XLA's CPU log1p and rounds the square root once)."""
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    np.testing.assert_array_equal(
        prng.uniform(key, shape, torch.float32, lo, 1.0,
                     device="cpu").numpy(),
        np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo, 1.0)),
    )
    want = np.asarray(jax.random.normal(jkey, shape, jnp.float32))
    got = prng.normal(key, shape, torch.float32, device="cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_log1p_f32_matches_xla():
    """XLA's CPU f32 log1p bit for bit on both branches (|x| below and
    above sqrt(2) - 1), over the range the normal draws feed it and
    beyond; zero, -1 and inf as XLA gives them."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1, 1, 200_000),
                        rng.uniform(0, 1e4, 50_000),
                        [-1.0, 0.0, -0.0, np.inf, 1e-30, -1e-30,
                         0.41421354, -0.41421354]]).astype(np.float32)
    want = np.asarray(jnp.log1p(jnp.asarray(x)))
    got = prng._log1p_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES + [(512, 96)])
def test_gumbel(seed, shape):
    """The uniform in [tiny, 1) bitwise; the Gumbel values within
    GUMBEL_ATOL (two logs in another library)."""
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    tiny = float(jnp.finfo(jnp.float32).tiny)
    np.testing.assert_array_equal(
        prng.uniform(key, shape, torch.float32, tiny, 1.0,
                     device="cpu").numpy(),
        np.asarray(jax.random.uniform(jkey, shape, jnp.float32, tiny, 1.0)),
    )
    want = np.asarray(jax.random.gumbel(jkey, shape))
    got = prng.gumbel(key, shape, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=GUMBEL_ATOL)


def test_wrapper_takes_the_plain_route_on_the_cpu():
    key = prng.PRNGKey(3)
    cuda_random.reset_launches()
    np.testing.assert_array_equal(
        cuda_random.gumbel(key, (9, 5), "cpu").numpy(),
        prng.gumbel(key, (9, 5), "cpu").numpy(),
    )
    np.testing.assert_array_equal(
        cuda_random.random_bits(key, (9, 5), "cpu").numpy(),
        prng.random_bits(key, 32, (9, 5), "cpu").numpy(),
    )
    assert all(v == 0 for v in cuda_random.launches.values())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES + [(256, 33)])
@pytest.mark.parametrize("dtype,tdtype", [(jnp.float32, torch.float32),
                                          (jnp.bfloat16, torch.bfloat16)])
def test_wrapper_normal_on_the_cpu_is_jax_s(seed, shape, dtype, tdtype):
    """The weight draw's wrapper on the CPU: its plain version, bitwise
    ``jax.random.normal``, and no launch."""
    cuda_random.reset_launches()
    want = jax.random.normal(jax.random.PRNGKey(seed), shape, dtype)
    got = cuda_random.normal(prng.PRNGKey(seed), shape, tdtype, "cpu")
    assert got.dtype == tdtype and got.device.type == "cpu"
    np.testing.assert_array_equal(_np(got), _jnp(want))
    assert cuda_random.launches["threefry_normal"] == 0
    assert cuda_random.plain_draws["threefry_normal"] == 1


def test_wrapper_refuses_a_device_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        cuda_random.gumbel(prng.PRNGKey(3), (4, 4), "meta")


def test_draws_take_an_explicit_device(monkeypatch):
    """Every draw names its device; ``None`` means ``cuda:0`` and raises
    without a card."""
    key = prng.PRNGKey(3)
    with pytest.raises(TypeError):
        prng.gumbel(key, (2, 2))
    with pytest.raises(TypeError):
        prng.normal(key, (2, 2), torch.bfloat16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for draw in (lambda: prng.random_bits(key, 32, (2, 2), None),
                 lambda: prng.uniform(key, (2, 2), device=None),
                 lambda: prng.normal(key, (2, 2), device=None),
                 lambda: prng.gumbel(key, (2, 2), None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            draw()


def test_key_and_dtype_validation():
    with pytest.raises(TypeError):
        prng.split(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        prng.random_bits(prng.PRNGKey(0), 64, (3,), "cpu")
    with pytest.raises(TypeError):
        prng.normal(prng.PRNGKey(0), (3,), torch.float16, device="cpu")


@pytest.mark.parametrize("seed", [0, 0x5EED, 0xFFFFFFFF])
@pytest.mark.parametrize("data", [0, 3, 0x9E3779B9])
def test_fold_in(seed, data):
    """``fold_in`` bit for bit ``jax.random.fold_in`` (the sharded dense
    solve folds each shard's index into its threefry key)."""
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    got = prng.fold_in(prng.PRNGKey(seed), data)
    assert got.dtype == torch.int64 and got.shape == (2,)
    assert got.tolist() == want.astype(np.int64).tolist()
