"""Port vs reference: the Mamba2 (SSD) layer.

Inputs are made with numpy from a seed; the layer's parameters are the
reference's ``init_mamba2`` draws copied into the port's ``Mamba2`` under
the same names.  ``ssd_chunked`` at chunks 4-32 and G in {1, 2} against
the reference's and a float64 sequential recurrence (the reference test's
oracle), its gradient against ``jax.grad`` (finite: the decay is masked
before ``exp``); ``mamba2_prefill`` (S padded to a multiple of the chunk)
and ``mamba2_decode`` against the reference's within 1e-4 in float32;
prefill-then-decode against one prefill; bf16 outputs stay bf16
(``tests/test_mamba.py``).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as JM
from repro_torch.bridge import _tensor_of, to_numpy
from repro_torch.models import mamba2 as M

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oracle(x, dt, a, b, c):
    """The sequential SSD recurrence in float64."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    x, dt, a = (np.asarray(t, np.float64) for t in (x, dt, a))
    bh = np.repeat(np.asarray(b, np.float64), rep, axis=2)
    ch = np.repeat(np.asarray(c, np.float64), rep, axis=2)
    h = np.zeros((B, H, P, N))
    ys = np.zeros((B, S, H, P))
    for t in range(S):
        decay = np.exp(dt[:, t] * a[None, :])
        h = h * decay[..., None, None] + np.einsum(
            "bh,bhp,bhn->bhpn", dt[:, t], x[:, t], bh[:, t])
        ys[:, t] = np.einsum("bhpn,bhn->bhp", h, ch[:, t])
    return ys, h


def _ssd_inputs(seed, B=2, S=32, H=4, P=8, N=6, G=1):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, S, H, P)).astype(np.float32),
            r.uniform(0.1, 0.9, size=(B, S, H)).astype(np.float32),
            -r.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
            r.normal(size=(B, S, G, N)).astype(np.float32),
            r.normal(size=(B, S, G, N)).astype(np.float32))


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_matches_reference_and_recurrence(chunk, G):
    args = _ssd_inputs(chunk + G, G=G)
    y, h = M.ssd_chunked(*map(torch.tensor, args), chunk)
    jy, jh = jax.jit(JM.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, args), chunk)
    assert h.dtype == torch.float32 and y.shape == args[0].shape
    np.testing.assert_allclose(to_numpy(y), np.asarray(jy), **TOL)
    np.testing.assert_allclose(to_numpy(h), np.asarray(jh), **TOL)
    ys, hs = _oracle(*args)
    np.testing.assert_allclose(to_numpy(y), ys, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(to_numpy(h), hs, rtol=3e-4, atol=3e-4)


def test_ssd_chunked_takes_an_initial_state():
    args = _ssd_inputs(3, G=2)
    h0 = np.random.default_rng(4).normal(size=(2, 4, 8, 6)).astype(np.float32)
    y, h = M.ssd_chunked(*map(torch.tensor, args), 8, torch.tensor(h0))
    jy, jh = JM.ssd_chunked(*map(jnp.asarray, args), 8, jnp.asarray(h0))
    np.testing.assert_allclose(to_numpy(y), np.asarray(jy), **TOL)
    np.testing.assert_allclose(to_numpy(h), np.asarray(jh), **TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_gradients_match_reference(G):
    """Every input's gradient of sum(sin(y)) + sum(h) is finite (the
    masked decay above the diagonal would give 0 * inf = NaN if masked
    after exp) and matches jax.grad."""
    args = _ssd_inputs(10 + G, G=G)
    ts = [torch.tensor(a).requires_grad_() for a in args]
    y, h = M.ssd_chunked(*ts, 8)
    grads = torch.autograd.grad(torch.sin(y).sum() + h.sum(), ts)

    def loss(*a):
        jy, jh = JM.ssd_chunked(*a, 8)
        return jnp.sum(jnp.sin(jy)) + jnp.sum(jh)

    jgrads = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(
        *map(jnp.asarray, args))
    for got, want, name in zip(grads, jgrads, ("x", "dt", "a", "b", "c")):
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


KW = dict(d_state=6, head_dim=4, expand=2)


def _layer(seed, d_model=16, dtype=jnp.float32, n_groups=1):
    """The reference's init_mamba2 draws and the port's layer holding
    them."""
    jp = JM.init_mamba2(jax.random.PRNGKey(seed), d_model, d_state=6,
                        head_dim=4, expand=2, n_groups=n_groups, dtype=dtype)
    p = M.Mamba2(d_model, d_state=6, head_dim=4, expand=2,
                 n_groups=n_groups,
                 dtype=getattr(torch, jnp.dtype(dtype).name), device="cpu")
    with torch.no_grad():
        for name, t in p.named_parameters():
            src = _tensor_of(np.asarray(jp[name]))
            assert src.shape == t.shape and src.dtype == t.dtype, name
            t.copy_(src)
    return jp, p


def test_parameters_are_the_reference_layout():
    jp, p = _layer(0)
    assert sorted(n for n, _ in p.named_parameters()) == sorted(jp)
    fresh = M.Mamba2(16, **KW, dtype=torch.bfloat16, device="cpu",
                     g=torch.Generator().manual_seed(0))
    jfresh = JM.init_mamba2(jax.random.PRNGKey(0), 16, **KW,
                            dtype=jnp.bfloat16)
    for name, t in fresh.named_parameters():
        assert tuple(t.shape) == jfresh[name].shape, name
        assert str(t.dtype).split(".")[1] == jfresh[name].dtype.name, name
    # the deterministic ones are the reference's (a_log's linspace and log
    # within a float32 rounding)
    for name in ("a_log", "d_skip", "dt_bias", "norm_scale", "conv_bx"):
        np.testing.assert_allclose(to_numpy(getattr(fresh, name)),
                                   np.asarray(jfresh[name], np.float32),
                                   rtol=3e-7, atol=0)


@pytest.mark.parametrize("S,chunk,n_groups", [(12, 4, 1), (13, 4, 1),
                                              (2, 4, 1), (24, 8, 2)])
def test_prefill_and_decode_match_reference(S, chunk, n_groups):
    """mamba2_prefill (S = 13 pads to 16; S = 2 is shorter than the conv
    window) and 4 decode steps after it, outputs and states."""
    kw = dict(KW, n_groups=n_groups)
    jp, p = _layer(1 + S, n_groups=n_groups)
    x = np.random.default_rng(S).normal(size=(2, S + 4, 16)).astype(
        np.float32)
    jprefill = jax.jit(partial(JM.mamba2_prefill, chunk=chunk, **kw))
    jdecode = jax.jit(partial(JM.mamba2_decode, **kw))
    y, h, cs = M.mamba2_prefill(p, torch.tensor(x[:, :S]), chunk=chunk, **kw)
    jy, jh, jcs = jprefill(jp, jnp.asarray(x[:, :S]))
    for got, want in ((y, jy), (h, jh), (cs, jcs)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)
    for t in range(S, S + 4):
        y, h, cs = M.mamba2_decode(p, torch.tensor(x[:, t:t + 1]), h, cs,
                                   **kw)
        jy, jh, jcs = jdecode(jp, jnp.asarray(x[:, t:t + 1]), jh, jcs)
        for got, want in ((y, jy), (h, jh), (cs, jcs)):
            np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                       **TOL, err_msg=f"step {t}")
    np.testing.assert_allclose(
        to_numpy(M.mamba2_forward(p, torch.tensor(x), chunk=chunk, **kw)),
        np.asarray(jax.jit(partial(JM.mamba2_forward, chunk=chunk, **kw))(
            jp, jnp.asarray(x))),
        **TOL)


def test_prefill_then_decode_matches_full():
    """The reference test, on the port alone."""
    _, p = _layer(0)
    x = torch.tensor(np.random.default_rng(0).normal(size=(2, 12, 16)).astype(
        np.float32))
    y_full, h_full, cs_full = M.mamba2_prefill(p, x, chunk=4, **KW)
    y_pre, h, cs = M.mamba2_prefill(p, x[:, :8], chunk=4, **KW)
    np.testing.assert_allclose(to_numpy(y_pre), to_numpy(y_full[:, :8]),
                               rtol=1e-4, atol=1e-4)
    for t in range(8, 12):
        y_t, h, cs = M.mamba2_decode(p, x[:, t:t + 1], h, cs, **KW)
        np.testing.assert_allclose(to_numpy(y_t[:, 0]),
                                   to_numpy(y_full[:, t]), rtol=5e-4,
                                   atol=5e-4)
    np.testing.assert_allclose(to_numpy(h), to_numpy(h_full), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(to_numpy(cs), to_numpy(cs_full), rtol=5e-4,
                               atol=5e-4)


def test_bf16_output_dtype_stable():
    """d_skip and the float32 internals do not promote the layer's output;
    the SSM state is float32 and the conv state bf16."""
    jp, p = _layer(0, dtype=jnp.bfloat16)
    assert p.a_log.dtype == p.d_skip.dtype == p.dt_bias.dtype == torch.float32
    x = np.random.default_rng(1).normal(size=(1, 8, 16)).astype(np.float32)
    xb = torch.tensor(x).bfloat16()
    y, h, cs = M.mamba2_prefill(p, xb, chunk=4, **KW)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert cs.dtype == torch.bfloat16
    y2, h2, cs2 = M.mamba2_decode(p, xb[:, :1], h, cs, **KW)
    assert y2.dtype == torch.bfloat16 and h2.dtype == torch.float32
    assert cs2.dtype == torch.bfloat16
    jy, jh, _ = jax.jit(partial(JM.mamba2_prefill, chunk=4, **KW))(
        jp, jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_allclose(to_numpy(y), np.asarray(jy, np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(to_numpy(h), np.asarray(jh), rtol=2e-2,
                               atol=2e-2)


def test_prefill_gradients_match_reference():
    """Autograd through the whole layer (projections, conv, SSD, gated
    norm) against jax.grad, every parameter."""
    jp, p = _layer(5)
    x = np.random.default_rng(5).normal(size=(2, 12, 16)).astype(np.float32)
    out = M.mamba2_forward(p, torch.tensor(x), chunk=4, **KW)
    names = [n for n, _ in p.named_parameters()]
    grads = torch.autograd.grad(torch.sin(out).sum(),
                                [t for _, t in p.named_parameters()])
    jgrads = jax.jit(jax.grad(lambda q: jnp.sum(jnp.sin(JM.mamba2_forward(
        q, jnp.asarray(x), chunk=4, **KW)))))(jp)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(to_numpy(g), np.asarray(jgrads[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
