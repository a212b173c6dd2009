"""Counter-based random bits: a numpy copy of ``jax.random``'s default
implementation.

The JAX package draws its committed sampling noise from ``jax.random``
(threefry2x32, with ``jax_threefry_partitionable`` on, the default since
jax 0.5). The port keeps its own copy so that a seed gives the same bytes
in both packages without importing JAX:

* ``prng_key(seed)`` is ``jax.random.PRNGKey(seed)`` as JAX builds it in
  its default 32-bit mode (``jax_enable_x64`` off, as the JAX package
  runs): the seed wraps to its low 32 bits, the key is the pair
  ``[seed >> 32, seed & 0xFFFFFFFF]`` of that, so the high word is 0;
* ``fold_in(key, data)`` hashes the key with the counter pair
  ``[0, data]`` (``data`` wraps to uint32, as ``jnp.uint32`` does);
* ``random_bits(key, shape)`` hashes the key with each element's flat
  row-major index, split into high and low words, and returns the XOR of
  the two output words (the partitionable layout).

Everything is uint32 numpy, which wraps on overflow exactly as the
threefry reference arithmetic does.
"""

import numpy as np

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds over the counter words ``x0`` and
    ``x1`` (uint32 arrays of one shape) under ``key`` (two uint32 words).
    Returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, dtype=np.uint32) + ks[0]
    x1 = np.asarray(x1, dtype=np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        # the round counter added in Python ints: a uint32 scalar sum
        # that wraps warns, where an array sum wraps silently
        x1 = x1 + np.uint32((int(ks[(i + 2) % 3]) + i + 1) & 0xFFFFFFFF)
    return x0, x1


def prng_key(seed):
    """``jax.random.PRNGKey(seed)``'s two uint32 words."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: a new key."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.concatenate([y0, y1])


def random_bits(key, shape):
    """``jax.random.bits(key, shape, "uint32")``: uint32 of ``shape``."""
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    y0, y1 = threefry2x32(key, hi, lo)
    return (y0 ^ y1).reshape(shape)
