"""Port vs reference: flash attention and the long-sequence attention path.

Inputs are made with numpy from a seed and go through the reference's
``repro.models.flash.flash_attention`` (pure JAX with a custom VJP) and the
port's ``repro_torch.models.flash.flash_attention`` (an autograd Function).
At the reference test's cases (``tests/test_flash.py``) the outputs and
the gradients of ``sum(sin(out))`` agree within rtol 1e-4 / atol 1e-5 in
float32; bf16 within 2e-2 + 2e-2 |x|.  ``blockwise_attention``,
``_chunk_of`` and ``_self_attention`` past the 1,024-token threshold
(where the KV heads are repeated and flash runs with G = 1) are held to
the reference the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash as JF
from repro.models import layers as JL
from repro_torch.bridge import to_numpy
from repro_torch.models import flash as F
from repro_torch.models import layers as L

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

#: the reference test's cases: (B, S, KV, G, hd, chunk)
CASES = [
    (2, 64, 2, 1, 8, 16),
    (1, 128, 1, 4, 16, 32),     # MQA
    (2, 256, 4, 2, 16, 64),     # GQA
    (1, 96, 3, 1, 8, 32),       # S not a power of two
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B, S, KV, G, hd, scale=1.0):
    r = np.random.default_rng(seed)
    q = (r.normal(size=(B, S, KV, G, hd)) * scale).astype(np.float32)
    k = (r.normal(size=(B, S, KV, hd)) * scale).astype(np.float32)
    v = r.normal(size=(B, S, KV, hd)).astype(np.float32)
    return q, k, v


def _t(a, dtype=torch.float32):
    return torch.tensor(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("B,S,KV,G,hd,chunk", CASES)
def test_forward_matches_reference(B, S, KV, G, hd, chunk):
    q, k, v = _qkv(S + KV, B, S, KV, G, hd)
    out = F.flash_attention(_t(q), _t(k), _t(v), chunk)
    jout = JF.flash_attention(_j(q), _j(k), _j(v), chunk)
    assert out.shape == (B, S, KV, G, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(out), np.asarray(jout), **TOL)
    dense = JL.dense_attention(_j(q).reshape(B, S, KV * G, hd), _j(k), _j(v))
    np.testing.assert_allclose(to_numpy(out).reshape(B, S, KV * G, hd),
                               np.asarray(dense), rtol=2e-5, atol=2e-5)


def _port_grads(q, k, v, chunk, dtype=torch.float32):
    ts = [_t(a, dtype).requires_grad_() for a in (q, k, v)]
    out = F.flash_attention(*ts, chunk)
    loss = torch.sin(out.float()).sum()
    return out, torch.autograd.grad(loss, ts)


def _reference_grads(q, k, v, chunk, dtype=jnp.float32):
    def loss(q, k, v):
        return jnp.sum(jnp.sin(JF.flash_attention(q, k, v, chunk).astype(
            jnp.float32)))
    args = [_j(a, dtype) for a in (q, k, v)]
    return (JF.flash_attention(*args, chunk),
            jax.grad(loss, argnums=(0, 1, 2))(*args))


@pytest.mark.parametrize("B,S,KV,G,hd,chunk", CASES[:3] + [
    (2, 128, 2, 3, 16, 16), (2, 128, 2, 3, 16, 64)])
def test_gradients_match_reference(B, S, KV, G, hd, chunk):
    """dq, dk, dv of sum(sin(out)) against jax.grad of the reference's
    custom VJP (the reference test's gradient cases among them)."""
    q, k, v = _qkv(chunk + G, B, S, KV, G, hd)
    _, grads = _port_grads(q, k, v, chunk)
    _, jgrads = _reference_grads(q, k, v, chunk)
    for got, want, name in zip(grads, jgrads, "qkv"):
        assert got.shape == want.shape
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL,
                                   err_msg=f"d{name}")


def test_gradients_match_autograd_through_dense():
    B, S, KV, G, hd, chunk = 2, 128, 2, 3, 16, 32
    q, k, v = _qkv(5, B, S, KV, G, hd)
    _, grads = _port_grads(q, k, v, chunk)
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    out = L.dense_attention(ts[0].reshape(B, S, KV * G, hd), ts[1], ts[2])
    dense = torch.autograd.grad(torch.sin(out).sum(), ts)
    for got, want, name in zip(grads, dense, "qkv"):
        np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=2e-4,
                                   atol=2e-4, err_msg=f"d{name}")


def test_bf16_matches_reference():
    """bf16 storage: the float32 softmax state, p cast to v's dtype before
    the PV product, and float32 products in the backward."""
    B, S, KV, G, hd, chunk = 1, 128, 2, 2, 16, 32
    q, k, v = _qkv(6, B, S, KV, G, hd)
    out, grads = _port_grads(q, k, v, chunk, torch.bfloat16)
    jout, jgrads = _reference_grads(q, k, v, chunk, jnp.bfloat16)
    assert out.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    np.testing.assert_allclose(to_numpy(out),
                               np.asarray(jout.astype(jnp.float32)),
                               **BF16_TOL)
    for got, want, name in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(to_numpy(got),
                                   np.asarray(want.astype(jnp.float32)),
                                   **BF16_TOL, err_msg=f"d{name}")


def test_numerically_stable_large_logits():
    """The online softmax survives large score magnitudes, as the
    reference's does, and agrees with it."""
    B, S, KV, G, hd = 1, 64, 1, 1, 8
    q, k, v = _qkv(7, B, S, KV, G, hd, scale=30.0)
    out, grads = _port_grads(q, k, v, 16)
    jout, jgrads = _reference_grads(q, k, v, 16)
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(g).all() for g in grads)
    np.testing.assert_allclose(to_numpy(out), np.asarray(jout), **TOL)
    for got, want in zip(grads, jgrads):
        scale = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-5 * max(1.0, scale))


def test_second_backward_is_bit_identical_and_saves_o_of_s():
    B, S, KV, G, hd, chunk = 1, 128, 2, 2, 8, 32
    q, k, v = _qkv(8, B, S, KV, G, hd)
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    out = F.flash_attention(*ts, chunk)
    # the residuals: q, k, v, out and the (B, S, KV, G) log-sum-exp
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [
        (B, S, KV, G, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, KV, G, hd),
        (B, S, KV, G)]
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    first = torch.autograd.grad(out, ts, dout, retain_graph=True)
    second = torch.autograd.grad(out, ts, dout)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_chunk_must_divide_the_sequence():
    q, k, v = _qkv(9, 1, 96, 1, 1, 8)
    with pytest.raises(AssertionError):
        F.flash_attention(_t(q), _t(k), _t(v), 64)


@pytest.mark.parametrize("B,S,H,KV,hd,chunk", [(2, 64, 2, 2, 8, 16),
                                               (1, 128, 4, 1, 16, 32),
                                               (2, 96, 6, 3, 8, 32)])
def test_blockwise_attention_matches_reference(B, S, H, KV, hd, chunk):
    r = np.random.default_rng(S + H)
    q = r.normal(size=(B, S, H, hd)).astype(np.float32)
    k = r.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = r.normal(size=(B, S, KV, hd)).astype(np.float32)
    out = L.blockwise_attention(_t(q), _t(k), _t(v), q_chunk=chunk,
                                kv_chunk=chunk)
    jout = JL.blockwise_attention(_j(q), _j(k), _j(v), q_chunk=chunk,
                                  kv_chunk=chunk)
    np.testing.assert_allclose(to_numpy(out), np.asarray(jout), **TOL)
    with pytest.raises(AssertionError, match="equal chunks"):
        L.blockwise_attention(_t(q), _t(k), _t(v), q_chunk=chunk,
                              kv_chunk=chunk // 2)


def test_blockwise_attention_differentiates():
    """blockwise_attention takes autograd's gradient through its loop:
    within 2e-4 of autograd through dense attention."""
    r = np.random.default_rng(11)
    q, k, v = (r.normal(size=(1, 64, 2, 8)).astype(np.float32)
               for _ in range(3))
    grads = []
    for fn in (lambda a, b, c: L.blockwise_attention(a, b, c, q_chunk=16,
                                                     kv_chunk=16),
               L.dense_attention):
        ts = [_t(a).requires_grad_() for a in (q, k, v)]
        grads.append(torch.autograd.grad(torch.sin(fn(*ts)).sum(), ts))
    for got, want in zip(*grads):
        np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("s", [1, 7, 96, 1024, 1280, 1536, 4104, 32768])
def test_chunk_of_matches_reference(s):
    assert L._chunk_of(s) == JL._chunk_of(s)


@pytest.mark.parametrize("S,H,KV", [(1280, 4, 2), (1536, 2, 2)])
def test_self_attention_past_the_threshold_matches_reference(S, H, KV):
    """Past BLOCK_THRESHOLD the KV heads are repeated to H and flash runs
    (chunk 256 at 1,280 tokens, 512 at 1,536): output and gradients
    against the reference's _self_attention."""
    assert S > L.BLOCK_THRESHOLD
    hd = 8
    r = np.random.default_rng(S)
    q = r.normal(size=(1, S, H, hd)).astype(np.float32)
    k = r.normal(size=(1, S, KV, hd)).astype(np.float32)
    v = r.normal(size=(1, S, KV, hd)).astype(np.float32)
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    out = L._self_attention(*ts)
    grads = torch.autograd.grad(torch.sin(out).sum(), ts)
    assert out.grad_fn is not None and "Flash" in repr(
        out.grad_fn.next_functions)
    jargs = [_j(a) for a in (q, k, v)]
    jout = JL._self_attention(*jargs)
    jgrads = jax.grad(lambda *a: jnp.sum(jnp.sin(JL._self_attention(*a))),
                      argnums=(0, 1, 2))(*jargs)
    np.testing.assert_allclose(to_numpy(out), np.asarray(jout), **TOL)
    for got, want, name in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL,
                                   err_msg=f"d{name}")
