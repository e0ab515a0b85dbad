"""Port vs reference: the token stream's samplers and synthetic batches.

``repro_torch.core.prng`` draws jax.random's bits without JAX, in torch
(int64 with 32-bit masks, here on the CPU), so ``repro_torch.data.tokens``
gives the reference's batch for the same ``(seed, step)``.  Bits, uniform
draws and Bernoulli draws are equal; Gumbel draws agree up to the last
places of ``log`` (torch's and XLA's round differently), so a token may
differ only where two perturbed logits tie within 2 ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import tokens as jtokens
from repro_torch.configs import base
from repro_torch.core import prng
from repro_torch.data import tokens

EPS32 = float(np.finfo(np.float32).eps)
#: Gumbel draws within this many eps of max(|value|, 1): two logs, each
#: rounded in its last place by another implementation
GUMBEL_EPS = 4.0


def _jkey(seed, *folds):
    k = jax.random.PRNGKey(seed)
    for d in folds:
        k = jax.random.fold_in(k, d)
    return k


def _key(seed, *folds):
    k = prng.prng_key(seed)
    for d in folds:
        k = prng.fold_in(k, d)
    return k


@pytest.mark.parametrize("seed,folds", [(0, (0,)), (3, (5, 1)),
                                        (12345, (2 ** 31 - 1, 7, 0))])
def test_fold_in_matches_jax(seed, folds):
    np.testing.assert_array_equal(_key(seed, *folds),
                                  np.asarray(jax.random.key_data(
                                      _jkey(seed, *folds))))


@pytest.mark.parametrize("shape", [(7,), (5, 33), (3, 4, 129)])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (float(np.finfo(
    np.float32).tiny), 1.0), (-2.0, 3.5)])
def test_uniform_matches_jax_bit_for_bit(shape, bounds):
    lo, hi = bounds
    want = np.asarray(jax.random.uniform(_jkey(4, 9), shape, jnp.float32,
                                         lo, hi))
    got = prng.uniform(_key(4, 9), shape, "cpu", lo, hi)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_bits_torch_equal_numpy_bits():
    key = _key(7, 3)
    n = 1000
    np.testing.assert_array_equal(
        prng.random_bits_torch(key, n, "cpu").numpy(),
        prng.random_bits(key, (n,)).astype(np.int64))


@pytest.mark.parametrize("p", [0.25, 0.5, 0.9])
def test_bernoulli_matches_jax_bit_for_bit(p):
    want = np.asarray(jax.random.bernoulli(_jkey(2, 1), p, (4, 65)))
    got = prng.bernoulli(_key(2, 1), p, (4, 65), "cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_gumbel_matches_jax_to_the_last_places_of_log():
    n = 200_000
    want = np.asarray(jax.random.gumbel(_jkey(3, 9), (n,))).astype(np.float64)
    scale = EPS32 * np.maximum(np.abs(want), 1.0)
    got = prng.gumbel(_key(3, 9), (n,), "cpu").numpy()
    assert got.dtype == np.float32
    assert np.max(np.abs(got - want) / scale) <= GUMBEL_EPS


def _tie_explains(jkey, logits, n, got, want):
    """Each position where ``got`` != ``want`` is a near-tie: the two
    largest perturbed logits of the reference's draw lie within 2 ulp, and
    ``got`` is one of them."""
    pert = np.asarray(jax.random.gumbel(jkey, (n, logits.shape[0]))
                      + logits[None, :])
    for t in np.flatnonzero(got != want):
        top2 = np.argsort(pert[t])[-2:]
        gap = pert[t, top2[1]] - pert[t, top2[0]]
        assert got[t] in top2 and gap <= 2 * np.spacing(
            np.float32(abs(pert[t, top2[1]]))), (t, gap)


@pytest.mark.parametrize("vocab,n", [(128, 65), (32064, 33)])
def test_categorical_matches_jax(vocab, n):
    logits = -np.log1p(np.arange(vocab, dtype=np.float32))
    jlogits = -jnp.log1p(jnp.arange(vocab, dtype=jnp.float32))
    want = np.asarray(jax.random.categorical(_jkey(1, 2), jlogits, shape=(n,)))
    got = prng.categorical(_key(1, 2), torch.tensor(logits), (n,)).numpy()
    assert got.shape == (n,)
    _tie_explains(_jkey(1, 2), logits, n, got, want)
    assert np.mean(got != want) < 1e-4


@pytest.mark.parametrize("seed,step,vocab,batch", [
    (0, 0, 128, 4), (1, 5, 128, 3), (2, 17, 1000, 2), (0, 3, 32064, 2)])
def test_synth_tokens_match_reference(seed, step, vocab, batch):
    """The reference's batch: tokens and labels equal but for near-ties of
    the Gumbel draw (none at these sizes), fewer than 1 in 10^4."""
    data = dict(seed=seed, seq_len=64, global_batch=batch)
    want = jtokens.synth_tokens(jtokens.DataConfig(**data), vocab, step)
    got = {k: v.numpy() for k, v in tokens.synth_tokens(
        tokens.DataConfig(**data), vocab, step, device="cpu").items()}
    for name in ("tokens", "labels"):
        w = np.asarray(want[name])
        assert got[name].dtype == np.int32 and got[name].shape == w.shape
        assert np.mean(got[name] != w) < 1e-4
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_synth_tokens_are_deterministic_and_slice_the_global_batch():
    data = tokens.DataConfig(seed=3, seq_len=32, global_batch=6)
    a = tokens.synth_tokens(data, 500, 5, device="cpu")
    b = tokens.synth_tokens(data, 500, 5, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    c = tokens.synth_tokens(data, 500, 6, device="cpu")
    assert not torch.equal(a["tokens"], c["tokens"])
    part = tokens.synth_tokens(data, 500, 5, batch_slice=slice(2, 5),
                               device="cpu")
    assert torch.equal(part["tokens"], a["tokens"][2:5])


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "phi3.5-moe-42b-a6.6b"])
def test_synth_batch_for_matches_reference(arch):
    cfg = base.reduced(base.get_config(arch))
    jcfg = jbase.reduced(jbase.get_config(arch))
    data = dict(seed=1, seq_len=48, global_batch=2)
    for step in (0, 4):
        want = jtokens.synth_batch_for(jcfg, jtokens.DataConfig(**data), step)
        got = tokens.synth_batch_for(cfg, tokens.DataConfig(**data), step,
                                     device="cpu")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-vl-7b"])
@pytest.mark.parametrize("reduce", [True, False], ids=["reduced", "full"])
def test_synth_batch_for_audio_and_vlm_match_reference(arch, reduce):
    """The audio and vlm batches: ``codes``, tokens, labels and positions
    bit for bit, the normal embeddings within 1e-6 (float32; at full
    size bf16, within one bf16 rounding of the reference's)."""
    cfg, jcfg = base.get_config(arch), jbase.get_config(arch)
    if reduce:
        cfg, jcfg = base.reduced(cfg), jbase.reduced(jcfg)
    data = dict(seed=3, seq_len=40, global_batch=2)
    for step in (0, 5):
        want = jtokens.synth_batch_for(jcfg, jtokens.DataConfig(**data), step)
        got = tokens.synth_batch_for(cfg, tokens.DataConfig(**data), step,
                                     device="cpu")
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k].astype(jnp.float32)
                           if want[k].dtype == jnp.bfloat16 else want[k])
            g = got[k].float().numpy() if got[k].is_floating_point() else \
                got[k].numpy()
            assert tuple(got[k].shape) == w.shape, k
            if k.endswith("_embeds"):
                assert got[k].dtype == cfg.torch_dtype
                tol = 1e-6 if reduce else 2.0 ** -8 * np.abs(w) + 1e-6
                assert np.all(np.abs(g - w) <= tol), k
            else:
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(g, w, err_msg=k)


def test_audio_and_vlm_batches_wait_for_their_stubs():
    """They wait no more (ROADMAP A15.5): an audio or vlm layout applied to
    another config gives that family's keys, dtypes and shapes."""
    cfg = base.reduced(base.get_config("qwen1.5-4b"))
    data = tokens.DataConfig(seq_len=12, global_batch=2)
    audio = tokens.synth_batch_for(
        dataclasses.replace(cfg, family="audio", n_codebooks=3), data, 0,
        device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in audio.items()} == {
        "frame_embeds": ((2, 12, 64), torch.float32),
        "codes": ((2, 12, 3), torch.int32)}
    vlm = tokens.synth_batch_for(
        dataclasses.replace(cfg, family="vlm", vision_tokens=16), data, 0,
        device="cpu")
    assert {k: tuple(v.shape) for k, v in vlm.items()} == {
        "tokens": (2, 6), "image_embeds": (2, 6, 64), "positions": (3, 2, 12),
        "labels": (2, 12)}
    assert (vlm["labels"][:, :6] == -1).all()


def test_synth_tokens_want_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tokens.synth_tokens(tokens.DataConfig(seq_len=4, global_batch=1),
                            16, 0)
