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

The samplers the synthetic batches draw from (``data/tokens.py``)
follow: :func:`fold_in` and :func:`split` on the host, then
:func:`uniform`, :func:`normal_torch`, :func:`randint`, :func:`gumbel`
(JAX's default mode ``"low"``), :func:`categorical` and :func:`bernoulli`
(mode ``"low"``) as tensors on a given device, Threefry in int64 with
32-bit masks: a row of a token batch at a 151,936-token vocabulary draws
~19.6 M Gumbel values, too many for the host in a trainer's step loop.
Keys stay numpy ``(2,)`` uint32 arrays on the host.  The bits, the
uniform draws and the integers equal JAX's.  The normal draws do too but
for the last places of ``log1p`` in XLA's float32 ``erf_inv`` polynomial
(three ulps at most), the Gumbel draws but for the last place of ``log``
(torch's and XLA's may round it differently), which can move an argmax
only where two perturbed logits tie within an ulp or two.
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


#: XLA's float32 ``erf_inv`` (Giles, "Approximating the erfinv function",
#: 2010): polynomial coefficients for ``w < 5`` and ``w >= 5``
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """``erf_inv`` of a float32 tensor as XLA computes it, in float32 (the
    exact inverse, even in float64, is up to ~2e-5 away from JAX's draws
    near |x| = 1, where ``log1p(-x * x)`` rounds)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(small, torch.tensor(_ERFINV_SMALL[i]),
                           torch.tensor(_ERFINV_LARGE[i])).to(x.device)

    p = coef(0)
    for i in range(1, len(_ERFINV_SMALL)):
        p = coef(i) + p * w
    return p * x


def normal_torch(key: np.ndarray, shape: tuple, device) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32 on ``device``: a
    uniform draw in ``[nextafter(-1, 0), 1)`` (:func:`uniform`), then
    ``sqrt(2) * erf_inv`` in float32 as XLA computes it (within three
    ulps of JAX's draws)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, device, lo, 1.0)
    return _erfinv32(u) * float(np.float32(np.sqrt(2)))


_INT32 = (-2 ** 31, 2 ** 31 - 1)


def _rem(x: torch.Tensor, span: int) -> torch.Tensor:
    """XLA's unsigned remainder: ``x`` itself by a span of 0."""
    return x if span == 0 else torch.remainder(x, span)


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """``a * m`` modulo 2**32 for ``a`` and ``m`` below 2**32, without
    leaving int64: ``m`` split into 16-bit halves."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def randint(key: np.ndarray, shape: tuple, minval: int, maxval: int,
            device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)`` as an
    int32 tensor on ``device`` (jax/_src/random.py ``_randint``): the key
    split in two, 32 higher and 32 lower bits a value, folded into the
    span ``maxval - minval`` by unsigned 32-bit remainders.  Bounds are
    clipped to int32 as JAX clips them; ``maxval <= minval`` gives
    ``minval``; a ``maxval`` above int32's range widens the span by one
    (to 0, which the remainders leave alone, for the whole range)."""
    out_of_range = maxval > _INT32[1]
    lo_v = min(max(int(minval), _INT32[0]), _INT32[1])
    hi_v = min(max(int(maxval), _INT32[0]), _INT32[1])
    k1, k2 = split(key)
    n = int(np.prod(shape, dtype=np.int64))
    higher = random_bits_torch(k1, n, device)
    lower = random_bits_torch(k2, n, device)
    span = (hi_v - lo_v) & _MASK
    if hi_v <= lo_v:
        span = 1
    if out_of_range and hi_v > lo_v:
        span = (span + 1) & _MASK
    multiplier = (2 ** 16) % span if span else 2 ** 16
    multiplier = (multiplier * multiplier) & _MASK
    multiplier = multiplier % span if span else multiplier
    offset = (_mul32(_rem(higher, span), multiplier)
              + _rem(lower, span)) & _MASK
    offset = _rem(offset, span)
    value = (lo_v + offset + 2 ** 31) & _MASK                   # int32 wrap
    return (value - 2 ** 31).to(torch.int32).reshape(shape)
