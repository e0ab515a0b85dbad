"""Port vs reference: the numpy Threefry generator and what it draws.

``repro_torch.core.prng`` reproduces jax.random's default generator without
JAX, so the port's dictionary, and with it the whole synthetic problem, is
the reference's for the same seed; its torch samplers ``randint`` and
``normal_torch`` draw the audio and vlm batches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import std as jstd
from repro.data.dmri import synth_connectome as jsynth
from repro_torch.bridge import to_numpy
from repro_torch.core import prng, std
from repro_torch.data.dmri import synth_connectome


def test_threefry_known_answers():
    """Random123's known-answer vectors for Threefry-2x32, 20 rounds."""
    got = prng.threefry2x32(np.uint32([0, 0]), np.uint32([0]), np.uint32([0]))
    assert (int(got[0][0]), int(got[1][0])) == (0x6B200159, 0x99BA4EFE)
    ones = np.uint32(0xFFFFFFFF)
    got = prng.threefry2x32(np.uint32([ones, ones]), np.uint32([ones]),
                            np.uint32([ones]))
    assert (int(got[0][0]), int(got[1][0])) == (0x1CB996FC, 0xBB002BE7)


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("n", [8, 96, 150])
def test_split_and_normal_match_jax(seed, n):
    key = prng.prng_key(seed)
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(jax.random.key_data(jkey)))
    np.testing.assert_array_equal(prng.split(key),
                                  np.asarray(jax.random.split(jkey)))
    np.testing.assert_array_equal(prng.split(key, n),
                                  np.asarray(jax.random.split(jkey, n)))
    k1 = prng.split(key)[0]
    got = prng.normal(k1, (n, 3))
    want = np.asarray(jax.random.normal(jax.random.split(jkey)[0], (n, 3)))
    assert got.dtype == np.float32 and got.shape == (n, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lo,hi", [
    (0, 2048), (0, 152064), (5, 6), (0, 1), (-7, 3), (9, 9), (9, 2),
    (-2 ** 31, 2 ** 31 - 1), (-2 ** 31, 0), (0, 2 ** 31 - 1),
    (3, 2 ** 31 - 1)],
    ids=lambda v: str(v))
def test_randint_matches_jax_bit_for_bit(lo, hi):
    """``jax.random.randint(..., jnp.int32)``: a span of 1, an empty span
    (``minval`` back), spans that are not powers of two, and the whole
    int32 range (its span wraps in unsigned 32-bit arithmetic)."""
    for seed, shape in ((0, (3, 5, 4)), (11, (4097,))):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
        want = np.asarray(jax.random.randint(jkey, shape, lo, hi, jnp.int32))
        got = prng.randint(prng.fold_in(prng.prng_key(seed), 1), shape, lo,
                           hi, "cpu")
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)
    if hi - lo == 1 or hi <= lo:
        assert (got == lo).all()


def test_randint_above_int32_widens_the_span():
    """``maxval`` past int32's range (JAX refuses such a Python int in
    jit; its rule: clip it, widen the span by one) gives the whole range:
    the span wraps to 0 and the remainders leave the lower bits as they
    are."""
    key = prng.prng_key(2)
    got = prng.randint(key, (64,), -2 ** 31, 2 ** 31, "cpu").numpy()
    lower = prng.random_bits(prng.split(key)[1], (64,))        # uint32
    np.testing.assert_array_equal(got, lower.astype(np.int64) - 2 ** 31)


@pytest.mark.parametrize("shape", [(7,), (4, 33, 16), (2, 64, 256)])
def test_normal_torch_matches_jax(shape):
    """Within 1e-6 (three float32 ulps at most) of ``jax.random.normal``
    (XLA's float32
    ``erf_inv`` polynomial; the exact inverse would be up to ~2e-5 off
    near the tails)."""
    for seed in (0, 9):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 4)
        want = np.asarray(jax.random.normal(jkey, shape))
        got = prng.normal_torch(prng.fold_in(prng.prng_key(seed), 4), shape,
                                "cpu")
        assert got.dtype == torch.float32
        err = np.abs(got.numpy() - want)
        assert np.all(err <= 3 * np.spacing(np.abs(want))), seed
        assert err.max() <= 1e-6


def test_split_key_of_seed_7():
    np.testing.assert_array_equal(prng.split(prng.prng_key(7))[0],
                                  np.uint32([3625411723, 1954958720]))


def test_prng_key_refuses_seeds_outside_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.prng_key(2 ** 31)


@pytest.mark.parametrize("n_atoms,n_theta", [(16, 12), (96, 96), (150, 96)])
@pytest.mark.parametrize("seed", [7, 3])
def test_make_dictionary_matches_reference(n_atoms, n_theta, seed):
    got = std.make_dictionary(n_atoms, n_theta, seed=seed, device="cpu")
    want = jstd.make_dictionary(n_atoms, n_theta,
                                key=jax.random.PRNGKey(seed))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("algorithm,seed", [("PROB", 5), ("DET", 2)])
def test_synth_connectome_is_the_reference_problem(algorithm, seed):
    """No dictionary carried across: Phi and w_true equal the reference's
    array for array, the dictionary and b to float32 rounding."""
    kw = dict(n_fibers=24, n_theta=12, n_atoms=16, grid=(8, 8, 8),
              algorithm=algorithm, seed=seed)
    ref = jsynth(**kw)
    got = synth_connectome(**kw, device="cpu")
    for name in ("atoms", "voxels", "fibers", "values"):
        np.testing.assert_array_equal(to_numpy(getattr(got.phi, name)),
                                      np.asarray(getattr(ref.phi, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(to_numpy(got.w_true), np.asarray(ref.w_true))
    np.testing.assert_allclose(to_numpy(got.dictionary),
                               np.asarray(ref.dictionary), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_numpy(got.b), np.asarray(ref.b), rtol=1e-5,
                               atol=1e-6)
    assert got.dictionary.dtype == torch.float32
    assert got.stats == ref.stats and got.grid == ref.grid
