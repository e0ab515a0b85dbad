"""JAX's default random-number generator in numpy.

The reference draws its dictionary's gradient directions from
``jax.random.normal(jax.random.split(jax.random.PRNGKey(seed))[0], ...)``.
The port may not import JAX, so this module computes the same numbers with
numpy alone: the Threefry-2x32 block cipher (20 rounds, Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011) and JAX's default
"partitionable" use of it, in which the counter of element ``i`` of a draw
is the 64-bit integer ``i`` split into its high and low 32-bit words.

Keys are ``uint32`` arrays of shape ``(2,)``.  :func:`normal` maps bits to
floats as JAX does (23 mantissa bits into ``[1, 2)``, shifted to
``[nextafter(-1, 0), 1)``, then ``sqrt(2) * erfinv``); ``erfinv`` is SciPy's,
in float64, so a draw differs from JAX's float32 one by the rounding of
that function alone (well under 1e-6).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.special import erfinv

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray,
                 x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` under ``key``: five
    groups of four rounds with a key injection after each group."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for group in range(5):
            for r in _ROTATIONS[group % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(group + 1) % 3]
            x[1] = x[1] + ks[(group + 2) % 3] + np.uint32(group + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed that fits in int32 (JAX's
    default, 64-bit types off): the words ``(0, seed mod 2**32)``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit in int32")
    return np.asarray([0, seed & 0xFFFFFFFF], np.uint32)


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)).astype(np.uint32),
            (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``(num, 2)`` uint32 keys."""
    b0, b1 = threefry2x32(key, *_counters(num))
    return np.stack([b0, b1], axis=1)


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    """32 random bits per element, as ``jax.random.bits`` draws them."""
    b0, b1 = threefry2x32(key, *_counters(int(np.prod(shape, dtype=np.int64))))
    return (b0 ^ b1).reshape(shape)


def normal(key: np.ndarray, shape: tuple) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32."""
    bits = random_bits(key, shape)
    one = np.float32(1.0)
    floats = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(
        np.float32) - one
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, floats * (one - lo) + lo)
    return (np.float32(np.sqrt(2)) * erfinv(u.astype(np.float64))).astype(
        np.float32)
