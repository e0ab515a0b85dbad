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

The samplers the synthetic token stream draws from (``data/tokens.py``)
follow: :func:`fold_in` on the host, then :func:`uniform`, :func:`gumbel`
(JAX's default mode ``"low"``), :func:`categorical` and :func:`bernoulli`
(mode ``"low"``) as tensors on a given device, Threefry in int64 with
32-bit masks: a row of a token batch at a 151,936-token vocabulary draws
~19.6 M Gumbel values, too many for the host in a trainer's step loop.
Keys stay numpy ``(2,)`` uint32 arrays on the host.  The bits and the
uniform draws equal JAX's; the Gumbel draws do too but for the last place
of ``log`` (torch's and XLA's may round it differently), which can move an
argmax only where two perturbed logits tie within an ulp or two.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
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


# ----------------------------------------------------------------------------
# The token stream's samplers (jax/_src/random.py: fold_in, _uniform,
# _gumbel, categorical, _bernoulli)
# ----------------------------------------------------------------------------

_MASK = 0xFFFFFFFF
#: float32's smallest normal number, the Gumbel sampler's lower bound
_TINY = float(np.finfo(np.float32).tiny)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: Threefry of the counter words
    ``(0, data)`` (``threefry_seed`` of a uint32) under ``key``."""
    b0, b1 = threefry2x32(key, np.uint32([0]), np.uint32([int(data) & _MASK]))
    return np.asarray([b0[0], b1[0]], np.uint32)


def random_bits_torch(key: np.ndarray, n: int, device) -> torch.Tensor:
    """:func:`random_bits` of ``n`` elements as int64 tensor on ``device``
    (values in [0, 2**32)): Threefry-2x32 in int64 arithmetic with 32-bit
    masks, the counters' high words those of ``i >> 32``."""
    k0, k1 = (int(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0 = (i >> 32).add_(ks[0]).bitwise_and_(_MASK)
    x1 = i.bitwise_and_(_MASK).add_(ks[1]).bitwise_and_(_MASK)
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            rot = (x1 << r).bitwise_and_(_MASK).bitwise_or_(x1 >> (32 - r))
            x1 = rot.bitwise_xor_(x0)
        x0.add_(ks[(group + 1) % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(group + 2) % 3] + group + 1).bitwise_and_(_MASK)
    return x0.bitwise_xor_(x1)


def uniform(key: np.ndarray, shape: tuple, device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` as a
    tensor on ``device``.  XLA fuses ``floats * (hi - lo) + lo`` into one
    multiply-add, rounded once; float64 holds the float32 product exactly,
    so it computes the same."""
    n = int(np.prod(shape, dtype=np.int64))
    bits = random_bits_torch(key, n, device)
    one_bits = int(np.float32(1.0).view(np.uint32))
    floats = (bits >> 9).bitwise_or_(one_bits).to(torch.int32).view(
        torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    fused = floats.double().mul_(float(hi - lo)).add_(float(lo))
    return torch.clamp_min(fused.float(), float(lo)).reshape(shape)


def gumbel(key: np.ndarray, shape: tuple, device) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32 on ``device``, mode
    ``"low"``: ``-log(-log(uniform(minval=tiny, maxval=1)))``."""
    u = uniform(key, shape, device, _TINY, 1.0)
    return u.log_().neg_().log_().neg_()


def categorical(key: np.ndarray, logits: torch.Tensor,
                shape: tuple) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=shape)`` for 1-D
    ``logits`` (V,) on their device: Gumbel noise of shape ``shape + (V,)``
    added to the logits, argmax over V (int64 indices)."""
    noise = gumbel(key, tuple(shape) + tuple(logits.shape), logits.device)
    return torch.argmax(noise.add_(logits), dim=-1)


def bernoulli(key: np.ndarray, p: float, shape: tuple,
              device) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` as a bool tensor on
    ``device``, mode ``"low"``: a float32 uniform draw below ``p``."""
    return uniform(key, shape, device) < float(np.float32(p))
