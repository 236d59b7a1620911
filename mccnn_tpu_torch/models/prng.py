"""JAX's default random numbers in numpy: the draws behind the seeded init.

The JAX package initializes its networks with ``jax.random.uniform``
from ``jax.random.PRNGKey(cfg.seed)`` (mccnn_tpu/cli.py:32-41,
mccnn_tpu/models/towers.py:35-68). This module computes the same bits
without JAX, so that one seed gives one net in both packages:

- the Threefry-2x32 hash (20 rounds, a key injection every 4), the
  algorithm of ``jax._src.prng.threefry_2x32``;
- the key of an integer seed, ``(0, seed mod 2**32)``, as
  ``PRNGKey`` builds it without 64-bit mode;
- ``split`` and ``random_bits`` in JAX's partitionable form (the
  default, ``jax_threefry_partitionable``): the counts are a
  (hi, lo) pair of uint32 words of a 64-bit iota over the output shape;
  ``split`` keeps both hash words as the new key, ``random_bits`` their
  XOR;
- ``uniform`` as ``jax._src.random._uniform``: 23 random mantissa bits
  under the exponent of 1.0, minus 1, scaled to [minval, maxval).

``u * (maxval - minval) + minval`` is computed in float64 and rounded to
float32 once: XLA's CPU backend fuses it into one fused multiply-add,
and the float64 product and sum of these float32 operands are exact, so
the single rounding is the FMA's.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the count pairs (x0, x1) under the key
    pair ``key`` (uint32 arrays; x0 and x1 of one shape)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the uint32 pair (0, seed mod 2**32)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _counts(shape) -> tuple[np.ndarray, np.ndarray]:
    """The (hi, lo) uint32 words of a uint64 iota of ``shape``."""
    n = int(np.prod(shape, dtype=np.int64))
    iota = np.arange(n, dtype=np.uint64).reshape(shape)
    return (iota >> np.uint64(32)).astype(np.uint32), iota.astype(np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: (num, 2) uint32 keys."""
    b0, b1 = threefry2x32(k, *_counts((num,)))
    return np.stack([b0, b1], axis=1)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """32 random bits a cell of ``shape``, as ``jax.random.bits``."""
    b0, b1 = threefry2x32(k, *_counts(tuple(shape)))
    return b0 ^ b1


def uniform(k: np.ndarray, shape, minval, maxval) -> np.ndarray:
    """``jax.random.uniform(k, shape, jnp.float32, minval, maxval)``:
    float32 in [minval, maxval)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    u = bits.view(np.float32) - np.float32(1.0)
    scaled = (u.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)
