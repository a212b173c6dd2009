"""Counter-based random bits: a copy of ``jax.random``'s default
implementation, on the host and in torch.

The JAX package draws every random number from ``jax.random``
(threefry2x32, with ``jax_threefry_partitionable`` on, the default since
jax 0.5): its executor's run keys, its random ops, dropout, and the
committed sampling noise. The port keeps its own copy so that a seed gives
the same bytes in both packages without importing JAX.

Keys. A key is a pair of 32-bit words, held on the host as a tuple of two
Python ints (the executor makes about 50 a BERT step, so each costs Python
arithmetic and no tensor):

* ``prng_key(seed)`` is ``jax.random.PRNGKey(seed)`` as JAX builds it in
  its default 32-bit mode (``jax_enable_x64`` off, as the JAX package
  runs): the seed wraps to its low 32 bits, the key is the pair
  ``[seed >> 32, seed & 0xFFFFFFFF]`` of that, so the high word is 0;
* ``fold_in(key, data)`` hashes the key with the counter pair
  ``[0, data]`` (``data`` wraps to uint32, as ``jnp.uint32`` does);
* ``split(key, num)`` is the partitionable split: key ``i`` hashes the
  counter pair of ``i``, the same words as ``fold_in(key, i)``.

Bits. ``random_bits(key, shape)`` hashes the key with each element's flat
row-major index, split into high and low words, and returns the XOR of
the two output words (the partitionable layout), as uint32 numpy.
``random_bits_torch(key, n, device, base)`` is the same in torch: int64
arithmetic masked to 32 bits, on any device, returned as the int32 view of
the uint32 words. It is the plain version of K8's ``random_bits``
(``kernels/random.py``). Both take a counter ``base``: element ``i``
hashes the index ``base + i``, so a draw at ``base`` is the slice
``[base, base + n)`` of a larger draw's flat bits. That is how a
data-parallel rank draws its rows of the global batch's mask: under the
partitionable layout, element ``i`` of a global draw depends on ``i``
alone.

Converters. ``uniform``, ``normal``, ``truncated_normal``, ``bernoulli``
and ``randint_from`` turn bits (int32 views) into ``jax.random``'s values
as ``jax/_src/random.py`` (jax 0.9.0) computes them in float32, and
``permutation`` runs ``_shuffle``'s rounds of stable sorts. ``normal``
and ``truncated_normal`` take XLA's single-precision ``ErfInv`` (Giles'
polynomial on ``w = -log1p(-x^2)``, the ``w < 5`` and ``w >= 5``
branches) over XLA's CPU ``log1p`` (a Cephes rational approximation for
small arguments, Cephes ``logf`` for the rest), each multiply-add fused as
XLA's CPU compiler fuses it: a fused step is one float64 product and sum,
exact for these operands, rounded once to float32. With that they give
the JAX package's CPU bits (``tests/test_torch_random.py``). A square
root is float64's rounded to float32: torch's float32 ``sqrt`` on the CPU
is not correctly rounded.
"""

import math

import numpy as np
import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "split", "random_bits",
           "random_bits_torch", "threefry2x32_torch", "uniform", "normal",
           "truncated_normal", "bernoulli", "randint_from", "permutation",
           "f32"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds over the counter words ``x0`` and
    ``x1`` (uint32 arrays of one shape) under ``key`` (two uint32 words).
    Returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    x0 = np.asarray(x0, dtype=np.uint32) + ks[0]
    x1 = np.asarray(x1, dtype=np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        # the round counter added in Python ints: a uint32 scalar sum
        # that wraps warns, where an array sum wraps silently
        x1 = x1 + np.uint32((int(ks[(i + 2) % 3]) + i + 1) & _M32)
    return x0, x1


def _threefry_words(k0, k1, x0, x1):
    """``threefry2x32`` of one counter pair, in Python ints (the rounds'
    key words unrolled: a key costs about 8 us of host time)."""
    k2 = k0 ^ k1 ^ _PARITY
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for a, b, rots in ((k1, k2 + 1, _ROTATIONS[0]), (k2, k0 + 2, _ROTATIONS[1]),
                       (k0, k1 + 3, _ROTATIONS[0]), (k1, k2 + 4, _ROTATIONS[1]),
                       (k2, k0 + 5, _ROTATIONS[0])):
        for r in rots:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32 | x1 >> (32 - r)) ^ x0
        x0 = (x0 + a) & _M32
        x1 = (x1 + b) & _M32
    return x0, x1


def prng_key(seed):
    """``jax.random.PRNGKey(seed)``'s two words."""
    return (0, int(seed) & _M32)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: a new key."""
    return _threefry_words(int(key[0]), int(key[1]), 0, int(data) & _M32)


def split(key, num=2):
    """``jax.random.split(key, num)`` (partitionable): ``num`` keys."""
    return [fold_in(key, i) for i in range(num)]


def random_bits(key, shape, base=0):
    """``jax.random.bits(key, shape, "uint32")``: uint32 of ``shape``;
    with ``base``, the elements ``[base, base + numel)`` of a larger
    draw's flat bits."""
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64) + np.uint64(int(base))
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(_M32)).astype(np.uint32)
    y0, y1 = threefry2x32(key, hi, lo)
    return (y0 ^ y1).reshape(shape)


# -- torch ------------------------------------------------------------------


def threefry2x32_torch(key, x0, x1):
    """``threefry2x32`` over int64 tensors holding uint32 words; returns
    the two output words, int64 in ``[0, 2^32)``."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & _M32)) & _M32
    return x0, x1


def random_bits_torch(key, n, device="cpu", base=0):
    """``random_bits(key, (n,), base)`` in torch on ``device``: int32
    ``[n]``, the uint32 words' bits."""
    idx = torch.arange(int(n), dtype=torch.int64, device=device) + int(base)
    y0, y1 = threefry2x32_torch(key, idx >> 32, idx & _M32)
    return _as_int32(y0 ^ y1)


def _as_int32(words):
    """int64 tensor of uint32 values -> int32 tensor of the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _unsigned(bits):
    """int32 view -> int64 tensor of the uint32 values."""
    return bits.to(torch.int64) & _M32


def f32(x):
    """Python float -> the nearest float32, as a Python float."""
    return float(np.float32(x))


def _fma32(a, b, c):
    """float32 ``a * b + c`` rounded once (a fused multiply-add): float64
    holds the product of two float32 values exactly, and the sum is exact
    for the operands of these polynomials, so one rounding to float32
    remains."""
    return (a.double() * b.double() + c.double()).float()


def _unit_floats(bits):
    """``jax.random.uniform``'s floats in [0, 1): the top 23 bits as the
    mantissa of a number in [1, 2), minus 1."""
    one = _unsigned(bits).__rshift__(9) | 0x3F800000
    return _as_int32(one).view(torch.float32) - 1.0


def uniform(bits, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` from
    ``bits``: ``max(lo, floats * (hi - lo) + lo)`` in float32, the
    multiply-add fused as XLA compiles it."""
    lo, hi = f32(minval), f32(maxval)
    floats = _unit_floats(bits)
    span = torch.full_like(floats, f32(hi - lo))
    return torch.clamp_min(_fma32(floats, span, torch.full_like(floats, lo)),
                           lo)


# XLA's ErfInv for float32 (Giles, "Approximating the erfinv function"):
# coefficients highest first, for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _poly32(x, coeffs):
    """Horner's rule from 0, highest coefficient first, each step fused."""
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma32(p, x, torch.full_like(x, f32(c)))
    return p


# XLA's CPU log1p: a Cephes rational approximation where |x| < sqrt(2) - 1,
# else log(1 + x) by XLA's CPU log (Cephes logf, below)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def _log32(v):
    """XLA's CPU float32 ``log`` of positive finite ``v`` (Cephes logf:
    ``v = m 2^e`` with m in [sqrt(1/2), sqrt(2)), a degree-9 polynomial
    in ``m - 1``, and ``e log 2`` in two parts), fused as XLA fuses it."""
    full = lambda c: torch.full_like(v, f32(c))  # noqa: E731
    b = torch.clamp_min(v, 1.1754943508222875e-38).view(torch.int32)
    e = ((b >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((b & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < f32(0.707106781186547524)
    t1 = torch.where(small, m, torch.zeros_like(m))
    m = m - 1.0
    e = e - small.to(torch.float32)
    m = m + t1
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma32(m, full(p[0]), full(p[1]))
    y1 = _fma32(m, full(p[3]), full(p[4]))
    y2 = _fma32(m, full(p[6]), full(p[7]))
    y = _fma32(y, m, full(p[2]))
    y1 = _fma32(y1, m, full(p[5]))
    y2 = _fma32(y2, m, full(p[8]))
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, e * f32(-2.12194440e-4))
    m = _fma32(full(-0.5), x2, m)
    m = m + y
    return _fma32(full(0.693359375), e, m)


def _log1p32(x):
    """XLA's CPU float32 ``log1p`` of ``x`` in (-1, 0]."""
    xx = x * x
    small = _poly32(x, _LOG1P_NUM) / _poly32(x, _LOG1P_DEN)
    small = (x * xx) * small
    small = x + _fma32(torch.full_like(x, -0.5), xx, small)
    big = _log32(x + 1.0)
    return torch.where(x.abs() < f32(0.41421356237309504880), small, big)


def erfinv32(x):
    """XLA's float32 ``ErfInv`` of a float32 tensor in (-1, 1)."""
    w = -_log1p32(x * -x)
    lt = w < 5.0
    # float64's sqrt rounded to float32 is float32's correctly rounded
    # sqrt (torch's float32 sqrt on the CPU is not, on some draws)
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    p = p.to(torch.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, f32(a), f32(b)).to(torch.float32)
        p = _fma32(p, w, c)
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


_SQRT2 = f32(math.sqrt(2.0))


def normal(bits):
    """``jax.random.normal(key, shape, float32)`` from ``bits``:
    ``sqrt(2) * erfinv(u)``, u uniform on (nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return erfinv32(uniform(bits, lo, 1.0)) * _SQRT2


def _erf32(x):
    """float32 ``erf`` of a Python float (a bound of the truncation)."""
    return f32(math.erf(f32(x)))


def truncated_normal(bits, lower, upper):
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``
    from ``bits``: uniform between ``erf(lower / sqrt2)`` and
    ``erf(upper / sqrt2)``, ``sqrt2 * erfinv`` of it, clipped to the
    float32 neighbours of the bounds inside them."""
    lo, hi = f32(lower), f32(upper)
    a, b = _erf32(f32(lo / _SQRT2)), _erf32(f32(hi / _SQRT2))
    out = erfinv32(uniform(bits, a, b)) * _SQRT2
    return out.clamp(float(np.nextafter(np.float32(lo), np.float32(np.inf))),
                     float(np.nextafter(np.float32(hi), np.float32(-np.inf))))


def bernoulli(bits, p):
    """``jax.random.bernoulli(key, p, shape)`` from ``bits``: uniform in
    [0, 1) below ``p`` as float32."""
    return _unit_floats(bits) < f32(p)


def randint_from(higher, lower, low, high):
    """``jax.random.randint(key, shape, low, high)`` (int32) from the bits
    of the two halves of ``split(key)``: ``low + offset`` with the offset
    ``((higher % span) * (2^32 % span) + lower % span) % span`` in uint32,
    wrapping as JAX's does. Returns int64."""
    low, high = int(low), int(high)
    span = 1 if high <= low else (high - low) & _M32
    mult = (2 ** 16) % span
    mult = (mult * mult & _M32) % span
    off = ((_unsigned(higher) % span) * mult & _M32) + _unsigned(lower) % span
    off = (off & _M32) % span
    out = (low + off) & _M32
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out)


def permutation(key, n, bits_fn=random_bits_torch, device="cpu"):
    """``jax.random.permutation(key, n)``: ``_shuffle``'s rounds of stable
    sorts of ``arange(n)`` by fresh 32-bit keys. ``bits_fn(key, n,
    device)`` draws each round's bits. Returns int64 ``[n]``."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        key, sub = split(key)
        sort_keys = _unsigned(bits_fn(sub, n, device))
        x = x[torch.sort(sort_keys, stable=True).indices]
    return x
