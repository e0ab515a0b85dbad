"""Port vs reference: kernel B7, the grouped matmul of the MoE expert FFN.

On the CPU the wrapper runs the plain version; these tests hold it against
the reference's Pallas kernel in interpret mode (as tests/test_kernels.py
runs it) and its gather oracle.  The CUDA kernel is held against the plain
version by ``chip_smoke.py`` and by the ``gpu``-marked test below on a card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.moe_gmm import moe_gmm as jmoe_gmm
from repro.kernels.ref import moe_gmm_ref as jmoe_gmm_ref
from repro_torch.bridge import to_numpy
from repro_torch.kernels import _build, ref
from repro_torch.kernels.moe_gmm import moe_gmm

FP32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)

#: tests/test_kernels.py:120-124, then t_tile 8 and a ragged E = 16
CASES = [
    (4, 32, 64, 8, 16, 64),
    (2, 16, 32, 4, 8, 32),
    (8, 64, 128, 16, 32, 128),
    (4, 32, 48, 6, 8, 48),
    (16, 40, 24, 11, 24, 8),
]


def _inputs(E, d, f, tiles, t_tile, seed):
    r = np.random.default_rng(seed)
    x = r.normal(size=(tiles * t_tile, d)).astype(np.float32)
    w = r.normal(size=(E, d, f)).astype(np.float32)
    eot = r.integers(0, E, size=(tiles,)).astype(np.int32)
    return x, w, eot


@pytest.mark.parametrize("E,d,f,tiles,t_tile,f_tile", CASES)
def test_plain_version_matches_reference_kernel(E, d, f, tiles, t_tile, f_tile):
    x, w, eot = _inputs(E, d, f, tiles, t_tile, E + d)
    want = jmoe_gmm(jnp.asarray(eot), jnp.asarray(x), jnp.asarray(w),
                    t_tile=t_tile, f_tile=f_tile, interpret=True)
    n = _build.launches("moe_gmm")
    got = moe_gmm(torch.tensor(eot), torch.tensor(x), torch.tensor(w),
                  t_tile=t_tile, f_tile=f_tile)
    assert _build.launches("moe_gmm") == n        # plain version: no launch
    assert got.shape == (tiles * t_tile, f) and got.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **FP32)


@pytest.mark.parametrize("E,d,f,tiles,t_tile,f_tile", CASES[:3])
def test_bf16_matches_reference_kernel(E, d, f, tiles, t_tile, f_tile):
    """bf16 in and out, float32 sums rounded once, as the Pallas body."""
    x, w, eot = _inputs(E, d, f, tiles, t_tile, E * d)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jmoe_gmm(jnp.asarray(eot), xb, wb, t_tile=t_tile, f_tile=f_tile,
                    interpret=True)
    got = moe_gmm(torch.tensor(eot), torch.tensor(x).bfloat16(),
                  torch.tensor(w).bfloat16(), t_tile=t_tile, f_tile=f_tile)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(got),
                               np.asarray(want.astype(jnp.float32)), **BF16)


def test_plain_version_matches_reference_oracle():
    """The run-by-run loop equals the reference's gather oracle, on
    non-monotone ids with runs of equal experts."""
    x, w, _ = _inputs(5, 24, 16, 9, 8, 3)
    eot = np.int32([3, 3, 0, 4, 4, 4, 1, 0, 0])
    want = jmoe_gmm_ref(jnp.asarray(x.reshape(9, 8, 24)), jnp.asarray(w),
                        jnp.asarray(eot))
    got = ref.moe_gmm_ref(torch.tensor(x).view(9, 8, 24), torch.tensor(w),
                          torch.tensor(eot))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **FP32)


def test_zero_rows_stay_zero_and_tiles_keep_their_expert():
    """Empty capacity slots (zero rows) come out zero; each tile is
    multiplied by its own expert only."""
    x, w, _ = _inputs(3, 16, 8, 4, 8, 5)
    x[8:16] = 0.0
    x[20:] = 0.0
    eot = np.int32([2, 0, 1, 2])
    got = to_numpy(moe_gmm(torch.tensor(eot), torch.tensor(x),
                           torch.tensor(w), t_tile=8))
    assert not got[8:16].any() and not got[20:].any()
    for t, e in enumerate(eot):
        np.testing.assert_allclose(got[t * 8:(t + 1) * 8],
                                   x[t * 8:(t + 1) * 8] @ w[e], **FP32)


@pytest.mark.parametrize("rows,n_ids,d_ff,t_tile,f_tile,match", [
    (30, 2, 64, 16, 64, "multiple of t_tile"),
    (32, 3, 64, 16, 64, "one entry per token tile"),
    (32, 2, 96, 16, 64, "multiple of f_tile"),
])
def test_argument_errors_match_reference(rows, n_ids, d_ff, t_tile, f_tile,
                                         match):
    x = np.zeros((rows, 8), np.float32)
    w = np.zeros((2, 8, d_ff), np.float32)
    eot = np.zeros((n_ids,), np.int32)
    with pytest.raises(ValueError, match=match):
        jmoe_gmm(jnp.asarray(eot), jnp.asarray(x), jnp.asarray(w),
                 t_tile=t_tile, f_tile=f_tile, interpret=True)
    with pytest.raises(ValueError, match=match):
        moe_gmm(torch.tensor(eot), torch.tensor(x), torch.tensor(w),
                t_tile=t_tile, f_tile=f_tile)


def test_wrapper_checks_operands():
    x, w, eot = _inputs(2, 16, 8, 2, 8, 1)
    tx, tw, te = torch.tensor(x), torch.tensor(w), torch.tensor(eot)
    with pytest.raises(TypeError, match="dtype"):
        moe_gmm(te, tx, tw.bfloat16(), t_tile=8)
    with pytest.raises(TypeError, match="dtype"):
        moe_gmm(te.long(), tx, tw, t_tile=8)
    with pytest.raises(ValueError, match="contiguous"):
        moe_gmm(te, tx.T.contiguous().T, tw, t_tile=8)
    with pytest.raises(ValueError, match="shape"):
        moe_gmm(te, tx, tw[:, :8], t_tile=8)


def test_build_knows_the_source():
    assert "moe_gmm" in _build.kernel_names()
    assert _build.library_path("moe_gmm").name.startswith("libmoe_gmm-")


def _on_card(rows, d, f, E, dtype, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
    w = (torch.randn(E, d, f, generator=g, device="cuda") / d ** 0.5).to(dtype)
    return g, x, w


def _held_to_plain(eot, x, w, t_tile):
    rows, d = x.shape
    n = _build.launches("moe_gmm")
    got = moe_gmm(eot, x, w, t_tile=t_tile, f_tile=8)
    torch.cuda.synchronize()
    assert _build.launches("moe_gmm") == n + 1
    want = ref.moe_gmm_ref(x.view(-1, t_tile, d), w, eot).view(rows, -1)
    tol = FP32 if x.dtype == torch.float32 else BF16
    torch.testing.assert_close(got, want, **tol)
    assert torch.equal(got, moe_gmm(eot, x, w, t_tile=t_tile, f_tile=8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,f,t_tile,E", [
    (256, 128, 256, 64, 4), (128, 256, 128, 8, 16), (144, 200, 136, 24, 16),
    (216, 64, 72, 72, 3), (256, 96, 200, 16, 5), (512, 128, 264, 32, 6),
    (768, 192, 320, 128, 3), (264, 40, 24, 24, 16)])
def test_cuda_kernel_matches_plain_version_on_card(dtype, rows, d, f, t_tile,
                                                   E):
    """t_tile 8 to 128 (and 24, 72: tiles cut into 64-row pieces), ragged
    N (200, 136, 72), the reference's ragged 40 -> 24; random ids."""
    g, x, w = _on_card(rows, d, f, E, dtype, rows + d)
    eot = torch.randint(0, E, (rows // t_tile,), generator=g, device="cuda",
                        dtype=torch.int32)
    _held_to_plain(eot, x, w, t_tile)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ids,t_tile", [
    ([0, 1, 2, 3, 4, 5, 6, 7], 64),           # a new expert every tile
    ([0, 1, 2, 3, 4, 5, 6, 7] * 2, 32),       # and inside a 128-row block
    ([5, 5, 0, 7, 7, 7, 2, 0], 64),           # unsorted, runs of equal ids
    ([-3, 0, 8, 99, 2, -1, 7, 4], 64),        # out of range: clamped
])
def test_cuda_kernel_expert_layouts_on_card(dtype, ids, t_tile):
    _, x, w = _on_card(len(ids) * t_tile, 128, 192, 8, dtype, len(ids))
    _held_to_plain(torch.tensor(ids, dtype=torch.int32, device="cuda"), x, w,
                   t_tile)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["prefill gate", "decode down"])
def test_cuda_kernel_at_serve_shapes_on_card(shape):
    """Phi-3.5-MoE's expert products on the serve path: 16 experts, 320
    rows each (t_tile 64) at prefill, 8 (t_tile 8) at decode; bf16."""
    rows, d, f, t_tile = {"prefill gate": (5120, 4096, 6400, 64),
                          "decode down": (128, 6400, 4096, 8)}[shape]
    _, x, w = _on_card(rows, d, f, 16, torch.bfloat16, 3)
    eot = torch.arange(16, dtype=torch.int32, device="cuda").repeat_interleave(
        rows // t_tile // 16)
    _held_to_plain(eot, x, w, t_tile)
