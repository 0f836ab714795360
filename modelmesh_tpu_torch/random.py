"""JAX's threefry PRNG (``jax.random`` as the JAX package uses it).

The model families draw their initial weights from
``jax.random.normal(PRNGKey(crc32(model_id)), ...)`` and the dense tier's
``noise_impl="threefry"`` draws ``jax.random.gumbel(PRNGKey(seed), shape)``,
so the port reproduces:

- ``PRNGKey(seed)``: the key ``[seed >> 32, seed & 0xFFFFFFFF]`` of a 32-bit
  seed (JAX without x64: the high word is 0, and a negative seed is taken
  as its two's complement);
- ``threefry2x32``: Threefry-2x32, 20 rounds, rotations 13/15/26/6 and
  17/29/16/24, a key injection every 4 rounds,
  ``ks2 = k0 ^ k1 ^ 0x1BD11BDA``;
- the partitionable layout (``jax_threefry_partitionable``, on by
  default): element i of a draw of any shape hashes the counter pair
  ``(i >> 32, i & 0xFFFFFFFF)`` of its flat row-major index, and its bits
  are the two output words XORed (cut to 8 or 16 bits for a narrower
  draw);
  ``split(key, n)`` hashes the counters 0..n-1 and keeps both words;
  ``fold_in(key, data)`` hashes the pair ``(0, data)``;
- ``uniform``: the top mantissa bits under exponent 0, minus 1, scaled and
  clamped in the draw's dtype, rounded as XLA rounds (each step in bf16,
  one fused multiply-add in f32);
- ``normal``: ``sqrt(2) * erf_inv(u)`` over ``u`` uniform in
  ``(nextafter(-1, 0), 1)``; bf16 takes ``torch.erfinv`` in f32 rounded to
  bf16 (a bf16 uniform takes 128 values, and on all of them this equals
  XLA), f32 XLA's own polynomial (M. Giles) with its fused multiply-adds,
  over XLA's CPU ``log1p`` (Cephes' rational form below sqrt(2) - 1,
  Cephes' ``logf`` of ``1 + x`` above, with the multiply-adds XLA's
  compiler fuses) and a correctly rounded square root;
- ``gumbel``: ``-log(-log(u))``, ``u`` uniform in ``[tiny, 1)`` (f32).

Arithmetic is on int64 tensors holding uint32 values, masked to 32 bits
(PyTorch has no uint32 ``>>`` on the CPU), as ``ops/auction.py``'s hash.
A key is an int64[2] tensor; every function takes it and a ``device``
explicitly and keeps no state. Draws are the plain version of
``ops/cuda_random.py``'s kernel and run on any device.
"""

from __future__ import annotations

import math

import torch

from modelmesh_tpu_torch.device import resolve_device

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# Coefficients of XLA's f32 erf_inv (M. Giles, "Approximating the erfinv
# function"), highest degree first, for w < 5 and w >= 5.
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)
# XLA's CPU log1p in f32: the Cephes rational approximation P(x)/Q(x)
# (coefficients lowest degree last) for |x| < sqrt(2) - 1, and Cephes'
# logf of 1 + x above it: the mantissa's polynomial, then the exponent
# times ln 2 split in two.
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOGF_SQRTHF = 0.707106781186547524
_LOGF_POLY = ((7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1),
              (-1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1),
              (2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOGF_LN2_LO, _LOGF_LN2_HI = -2.12194440e-4, 0.693359375
# (random bits drawn, mantissa bits, the bit pattern of 1.0, the int dtype
# of the same width) of each float dtype a uniform can be drawn in. JAX
# draws at least 8 bits: a bf16 uniform takes 8 and drops the lowest.
_FLOAT_LAYOUT = {
    torch.float32: (32, 23, 0x3F800000, torch.int32),
    torch.bfloat16: (8, 7, 0x3F80, torch.int16),
}


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (JAX without x64) as int64[2] on the
    CPU: ``[0, seed mod 2**32]``. Seeds outside [-2**31, 2**32) raise, as
    they overflow JAX's 32-bit seed."""
    seed = int(seed)
    if not -(1 << 31) <= seed <= MASK32:
        raise OverflowError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64)


def _words(key: torch.Tensor) -> tuple[int, int]:
    if key.shape != (2,):
        raise TypeError(f"a key is int64[2] (got {list(key.shape)})")
    k0, k1 = (int(v) for v in key.tolist())
    if not (0 <= k0 <= MASK32 and 0 <= k1 <= MASK32):
        raise ValueError(f"key words must be uint32 (got {k0}, {k1})")
    return k0, k1


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the counter pairs ``(x0, x1)`` (int64 tensors of
    uint32 values, one shape) under ``key``: the two output words."""
    k0, k1 = _words(key)
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) & MASK32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def _counters(shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The flat row-major index of each element of ``shape`` as its
    (high, low) 32-bit words (``iota_2x32_shape``), on ``device``
    (``None``: ``cuda:0`` or raise)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=resolve_device(device))
    idx = idx.reshape(tuple(shape))
    return idx >> 32, idx & MASK32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: int64[num, 2] on the CPU."""
    hi, lo = _counters((num,), "cpu")
    b0, b1 = threefry2x32(key, hi, lo)
    return torch.stack([b0, b1], dim=1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry2x32 of ``key`` over the
    seed words of ``data`` (``[0, data mod 2**32]``), int64[2] on the
    CPU."""
    b0, b1 = threefry2x32(key, torch.tensor([0], dtype=torch.int64),
                          torch.tensor([int(data) & MASK32],
                                       dtype=torch.int64))
    return torch.cat([b0, b1])


def random_bits(key: torch.Tensor, bit_width: int, shape,
                device) -> torch.Tensor:
    """``jax.random.bits`` of ``bit_width`` (8, 16 or 32) and ``shape``,
    as int64 values in [0, 2**bit_width)."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width {bit_width} (expected 8 | 16 | 32)")
    hi, lo = _counters(shape, device)
    b0, b1 = threefry2x32(key, hi, lo)
    bits = b0 ^ b1
    return bits if bit_width == 32 else bits & ((1 << bit_width) - 1)


def uniform(key: torch.Tensor, shape, dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0, *,
            device) -> torch.Tensor:
    """``jax.random.uniform``: values in [minval, maxval) of ``dtype``
    (f32 or bf16)."""
    if dtype not in _FLOAT_LAYOUT:
        raise TypeError(f"uniform draws f32 or bf16 (got {dtype})")
    rng_bits, nmant, one_bits, int_dtype = _FLOAT_LAYOUT[dtype]
    bits = random_bits(key, rng_bits, shape, device)
    floats = (((bits >> (rng_bits - nmant)) | one_bits).to(int_dtype)
              .view(dtype)) - torch.tensor(1.0, dtype=dtype)
    lo = torch.tensor(minval, dtype=dtype, device=floats.device)
    hi = torch.tensor(maxval, dtype=dtype, device=floats.device)
    if dtype == torch.bfloat16:
        # XLA rounds each bf16 step.
        return torch.maximum(lo, floats * (hi - lo) + lo)
    # In f32 XLA fuses the scale and the shift into one multiply-add,
    # rounded once; in f64 the product of two f32 values is exact.
    scaled = floats.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.float())


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once: the product of two f32 values is
    exact in f64."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def _logf(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 log (Cephes' ``logf``), with the multiply-adds its
    compiler fuses. Zero gives -inf, inf gives inf, below zero NaN."""
    tiny = _f32(torch.finfo(torch.float32).tiny)
    bits = torch.where(v > tiny, v, tiny).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < _f32(_LOGF_SQRTHF)
    xm = (m - 1.0) + torch.where(low, m, _f32(0.0))
    e = e - low.to(torch.float32)
    z = xm * xm
    x3 = z * xm
    y1, y2, y3 = (_fma(_fma(xm, _f32(a), _f32(b)), xm, _f32(c))
                  for a, b, c in _LOGF_POLY)
    y = _fma(_fma(y1, x3, y2), x3, y3)
    y = _fma(y, x3, e * _f32(_LOGF_LN2_LO))
    r = _fma(e, _f32(_LOGF_LN2_HI), (xm - z * 0.5) + y)
    r = torch.where(v > 0, r, _f32(math.nan))
    r = torch.where(v == math.inf, _f32(math.inf), r)
    return torch.where(v == 0, _f32(-math.inf), r)


def _log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 log1p: the rational form below sqrt(2) - 1, else
    ``_logf(1 + x)``."""
    x2 = x * x
    num = _f32(_LOG1P_P[0])
    for c in _LOG1P_P[1:]:
        num = _fma(num, x, _f32(c))
    den = _f32(_LOG1P_Q[0])
    for c in _LOG1P_Q[1:]:
        den = _fma(den, x, _f32(c))
    small = x + _fma(x2, _f32(-0.5), (x * x2) * (num / den))
    return torch.where(x.abs() < _f32(_LOG1P_SMALL), small,
                       _logf(x + 1.0))


def _erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erf_inv: Giles' polynomial in w = -log1p(-x*x), each
    step a fused multiply-add, over XLA's log1p and a correctly rounded
    square root (f64, rounded once; PyTorch's vectorized f32 ``sqrt`` on
    the CPU is not always)."""
    w = -_log1p_f32(-x * x)
    low = w < 5.0
    w = torch.where(low, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = None
    for a, b in zip(_ERFINV_LO, _ERFINV_HI):
        c = torch.where(low, _f32(a), _f32(b))
        p = c if p is None else _fma(p, w, c)
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def normal(key: torch.Tensor, shape, dtype=torch.float32, *,
           device) -> torch.Tensor:
    """``jax.random.normal`` in f32 or bf16."""
    if dtype not in _FLOAT_LAYOUT:
        raise TypeError(f"normal draws f32 or bf16 (got {dtype})")
    # nextafter(-1, 0) in the dtype: -(1 - eps / 2).
    lo = -(1.0 - torch.finfo(dtype).eps / 2)
    u = uniform(key, shape, dtype, lo, 1.0, device=device)
    sqrt2 = torch.tensor(math.sqrt(2), dtype=dtype)
    if dtype == torch.bfloat16:
        return torch.erfinv(u.float()).to(torch.bfloat16) * sqrt2
    return _erf_inv_f32(u) * sqrt2


def gumbel(key: torch.Tensor, shape, device) -> torch.Tensor:
    """``jax.random.gumbel`` (f32, mode "low"): ``-log(-log(u))``, ``u``
    uniform in [tiny, 1)."""
    u = uniform(key, shape, torch.float32,
                torch.finfo(torch.float32).tiny, 1.0, device=device)
    return -torch.log(-torch.log(u))
