"""Port vs reference: the format kernels B3 (SELL DSC), B4 (SELL WC), B5
(F-COO DSC) and B6 (F-COO WC).

On the CPU the wrappers run their kernels' plain PyTorch versions.  These
tests hold the plain versions against the reference's Pallas kernels run
in interpret mode on the same operands (as tests/test_formats.py and
tests/test_fcoo.py run them), B5's and B6's segment partials included,
zeros and all; they hold the F-COO ops to a float64 oracle with a
tolerance scaled by the sum of |terms| per output (fp32 sums in two orders
differ by more than a fixed bound on long duplicate runs, ROADMAP §C); and
they check the wrappers' dispatch and operand checks.  The CUDA kernels
themselves are held against the plain versions by ``chip_smoke.py`` and by
the ``gpu``-marked tests below on a card.

Tolerances: rtol 2e-4 / atol 2e-5 in fp32 (the conformance bound), 2e-2
with bf16 storage (repro/tune/plan.py BF16_RTOL/ATOL).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.std import PhiTensor as JPhi
from repro.formats import fcoo as jfcoo
from repro.formats import sell as jsell
from repro.kernels import dsc as jdsc
from repro.kernels import fcoo as jfk
from repro.kernels import ops as jops
from repro.kernels import wc as jwc
from repro_torch.bridge import to_numpy
from repro_torch.core.std import PhiTensor
from repro_torch.formats.fcoo import FcooPhi
from repro_torch.formats.sell import SellPhi
from repro_torch.kernels import _build, dsc, fcoo, ops, wc

FP32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
TOL = {"fp32": FP32, "bf16": BF16}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _phi(nc, na, nv, nf, seed, hot=0, skip=()):
    """Both packages' Phi over the same numpy arrays; ``hot`` duplicates on
    voxel 3 / fiber 5 make a row longer than a slot tile and a run across
    chunks; ids in ``skip`` get no coefficient (empty rows)."""
    r = np.random.default_rng(seed)

    def ids(n, hot_id):
        allowed = np.setdiff1d(np.arange(n), skip)
        return np.concatenate([r.choice(allowed, nc), np.full(hot, hot_id)])

    a = r.integers(0, na, nc + hot)
    v, f = ids(nv, 3), ids(nf, 5)
    vals = r.normal(size=nc + hot).astype(np.float32)
    j = JPhi(atoms=jnp.asarray(a, jnp.int32), voxels=jnp.asarray(v, jnp.int32),
             fibers=jnp.asarray(f, jnp.int32), values=jnp.asarray(vals),
             n_atoms=na, n_voxels=nv, n_fibers=nf)
    t = PhiTensor(atoms=torch.tensor(a, dtype=torch.int32),
                  voxels=torch.tensor(v, dtype=torch.int32),
                  fibers=torch.tensor(f, dtype=torch.int32),
                  values=torch.tensor(vals), n_atoms=na, n_voxels=nv,
                  n_fibers=nf)
    return j, t


def _inputs(na, nv, nf, n_theta, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(na, n_theta)).astype(np.float32),
            r.uniform(size=nf).astype(np.float32),
            r.normal(size=(nv, n_theta)).astype(np.float32))


#: (nc, na, nv, nf, hot, skip, n_theta, row_tile, slot_tile, c_tile)
SHAPES = {
    "ragged": (400, 10, 60, 40, 90, np.r_[16:24], 12, 8, 32, 64),
    "narrow": (150, 5, 22, 12, 0, (), 16, 4, 16, 32),
}


def _sell_pair(case, op, compute_dtype):
    nc, na, nv, nf, hot, skip, nt, rt, st, _ = SHAPES[case]
    j, t = _phi(nc, na, nv, nf, seed=nc, hot=hot, skip=skip)
    enc = SellPhi.encode(t, op=op, row_tile=rt, slot_tile=st)
    jenc = jsell.SellPhi.encode(j, op=op, row_tile=rt, slot_tile=st)
    o = ops.sell_operands(enc, "cpu", compute_dtype=compute_dtype)
    d, w, y = _inputs(na, nv, nf, nt, seed=nc + 1)
    return enc, jenc, o, d, w, y


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", SHAPES)
def test_dsc_sell_plain_matches_pallas_kernel(case, compute_dtype):
    enc, jenc, o, d, w, _ = _sell_pair(case, "dsc", compute_dtype)
    assert enc.row_nnz.max() > enc.slot_tile or case == "narrow"
    dt = ops.storage_cast(torch.tensor(d), compute_dtype)
    got = dsc.dsc_sell(o.atoms, o.others, o.values, o.row_nnz, dt,
                       torch.tensor(w), row_tile=o.row_tile)
    scaled = (jnp.take(jnp.asarray(w), jnp.asarray(jenc.others))
              * jnp.asarray(jenc.values).astype(JDT[compute_dtype]))
    want = jdsc.dsc_sell_pallas(
        jnp.asarray(jenc.atoms), scaled,
        jops.pad_lanes(jnp.asarray(d).astype(JDT[compute_dtype])),
        row_tile=jenc.row_tile, slot_tile=jenc.slot_tile,
        out_dtype=jnp.float32, interpret=True)
    assert got.shape == (enc.atoms.shape[0], d.shape[1])
    np.testing.assert_allclose(to_numpy(got),
                               np.asarray(want)[:, :d.shape[1]],
                               **TOL[compute_dtype])
    empty = np.r_[np.nonzero(enc.row_nnz == 0)[0],
                  np.arange(enc.n_rows, enc.atoms.shape[0])]
    assert empty.size and torch.count_nonzero(got[empty]) == 0


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", SHAPES)
def test_wc_sell_plain_matches_pallas_kernel(case, compute_dtype):
    enc, jenc, o, d, _, y = _sell_pair(case, "wc", compute_dtype)
    dt = ops.storage_cast(torch.tensor(d), compute_dtype)
    got = wc.wc_sell(o.atoms, o.others, o.values, o.row_nnz, dt,
                     torch.tensor(y))
    y_pad = jops.pad_lanes(jnp.asarray(y))
    want = jwc.wc_sell_pallas(
        jnp.asarray(jenc.atoms), jnp.take(y_pad, jnp.asarray(jenc.others),
                                          axis=0),
        jnp.asarray(jenc.values).astype(JDT[compute_dtype]),
        jops.pad_lanes(jnp.asarray(d).astype(JDT[compute_dtype])),
        row_tile=jenc.row_tile, slot_tile=jenc.slot_tile,
        out_dtype=jnp.float32, interpret=True)
    assert got.shape == (enc.atoms.shape[0],)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want).reshape(-1),
                               **TOL[compute_dtype])


def _fcoo_pair(case, compute_dtype, c_tile=None):
    nc, na, nv, nf, hot, skip, nt, _, _, ct = SHAPES[case]
    j, t = _phi(nc, na, nv, nf, seed=2 * nc, hot=hot, skip=skip)
    ct = c_tile or ct
    enc = FcooPhi.encode(t, c_tile=ct, seg_tile=4)
    jenc = jfcoo.FcooPhi.encode(j, c_tile=ct, seg_tile=4)
    o = ops.fcoo_operands(enc, "cpu", compute_dtype=compute_dtype)
    d, w, y = _inputs(na, nv, nf, nt, seed=nc + 2)
    return enc, jenc, o, d, w, y


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", SHAPES)
def test_dsc_fcoo_partials_match_pallas_kernel(case, compute_dtype):
    """B5's (n_chunks, K, Ntheta) partials equal the Pallas kernel's slot
    for slot, zeros past each chunk's last segment included."""
    enc, jenc, o, d, w, _ = _fcoo_pair(case, compute_dtype)
    dt = ops.storage_cast(torch.tensor(d), compute_dtype)
    got = ops.fcoo_dsc_partials(o, dt, torch.tensor(w))
    shape = (jenc.n_chunks, jenc.c_tile)
    scaled = (jnp.take(jnp.asarray(w), jnp.asarray(jenc.fibers))
              * jnp.asarray(jenc.values).astype(JDT[compute_dtype]))
    want = jfk.dsc_fcoo_pallas(
        jnp.asarray(jenc.atoms).reshape(shape),
        jnp.asarray(jenc.dsc_ranks).reshape(shape), scaled.reshape(shape),
        jops.pad_lanes(jnp.asarray(d).astype(JDT[compute_dtype])),
        seg_k=jenc.k_dsc, out_dtype=jnp.float32, interpret=True)
    assert got.shape == (enc.n_chunks, enc.k_dsc, d.shape[1])
    want = np.asarray(want)[..., :d.shape[1]]
    np.testing.assert_allclose(to_numpy(got), want, **TOL[compute_dtype])
    n_segs = enc.dsc_ranks.reshape(shape)[:, -1] + 1
    past = np.arange(enc.k_dsc)[None, :] >= n_segs[:, None]
    assert past.any() and not to_numpy(got)[past].any() and not want[past].any()


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", SHAPES)
def test_wc_fcoo_partials_match_pallas_kernel(case, compute_dtype):
    """B6's (n_chunks, K) partials, read through wc_perm, equal the Pallas
    kernel's over the reference's pre-gathered view."""
    enc, jenc, o, d, _, y = _fcoo_pair(case, compute_dtype)
    dt = ops.storage_cast(torch.tensor(d), compute_dtype)
    got = ops.fcoo_wc_partials(o, dt, torch.tensor(y))
    shape = (jenc.n_chunks, jenc.c_tile)
    perm = jnp.asarray(jenc.wc_perm)
    y_pad = jops.pad_lanes(jnp.asarray(y))
    want = jfk.wc_fcoo_pallas(
        jnp.take(jnp.asarray(jenc.atoms), perm).reshape(shape),
        jnp.asarray(jenc.wc_ranks).reshape(shape),
        jnp.take(jnp.asarray(jenc.values).astype(JDT[compute_dtype]),
                 perm).reshape(shape),
        jnp.take(y_pad, jnp.take(jnp.asarray(jenc.voxels), perm),
                 axis=0).reshape(*shape, y_pad.shape[1]),
        jops.pad_lanes(jnp.asarray(d).astype(JDT[compute_dtype])),
        seg_k=jenc.k_wc, out_dtype=jnp.float32, interpret=True)
    assert got.shape == (enc.n_chunks, enc.k_wc)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                               **TOL[compute_dtype])


# ----------------------------------------------------------------------------
# F-COO ops against a float64 oracle
# ----------------------------------------------------------------------------

def _oracle(t, d, w, y):
    """float64 y = M w and w = M^T y, plus sum |terms| per output."""
    a, v, f = (x.numpy().astype(np.int64) for x in (t.atoms, t.voxels,
                                                     t.fibers))
    vals = t.values.numpy().astype(np.float64)
    d64, w64, y64 = (x.astype(np.float64) for x in (d, w, y))
    terms = d64[a] * (w64[f] * vals)[:, None]
    ym = np.zeros((t.n_voxels, d.shape[1]))
    ys = np.zeros_like(ym)
    np.add.at(ym, v, terms)
    np.add.at(ys, v, np.abs(terms))
    dots = (d64[a] * y64[v]).sum(1) * vals
    dots_abs = (np.abs(d64[a]) * np.abs(y64[v])).sum(1) * np.abs(vals)
    wm, ws = np.zeros(t.n_fibers), np.zeros(t.n_fibers)
    np.add.at(wm, f, dots)
    np.add.at(ws, f, dots_abs)
    return ym, ys, wm, ws


@pytest.mark.parametrize("case", ["run-across-chunks", "chunk-at-k-limit"])
def test_fcoo_ops_match_float64_oracle(case):
    if case == "run-across-chunks":
        # ~130 duplicate triples on voxel 3 / fiber 5 span several chunks
        _, t = _phi(300, 6, 40, 20, seed=11, hot=130)
        c_tile = 32
    else:
        # every slot its own segment: a chunk holds c_tile segments, K's
        # largest value
        nv = nf = 64
        t = PhiTensor(atoms=torch.arange(nv, dtype=torch.int32) % 4,
                      voxels=torch.arange(nv, dtype=torch.int32),
                      fibers=torch.arange(nf, dtype=torch.int32).flip(0),
                      values=torch.linspace(-1, 1, nv), n_atoms=4,
                      n_voxels=nv, n_fibers=nf)
        c_tile = 32
    enc = FcooPhi.encode(t, c_tile=c_tile, seg_tile=4)
    if case == "run-across-chunks":          # voxel 3 and fiber 5 each
        assert sum(3 in r for r in enc.seg_rows_dsc) > 1     # span chunks
        assert sum(5 in r for r in enc.seg_rows_wc) > 1
    else:
        assert enc.k_dsc == enc.k_wc == c_tile
    d, w, y = _inputs(t.n_atoms, t.n_voxels, t.n_fibers, 8, seed=12)
    matvec, rmatvec = ops.make_fcoo_ops(enc, torch.tensor(d))
    ym, ys, wm, ws = _oracle(t, d, w, y)
    eps = 8 * np.finfo(np.float32).eps
    got_y = to_numpy(matvec(torch.tensor(w))).astype(np.float64)
    got_w = to_numpy(rmatvec(torch.tensor(y))).astype(np.float64)
    assert np.all(np.abs(got_y - ym) <= eps * ys + 1e-12)
    assert np.all(np.abs(got_w - wm) <= eps * ws + 1e-12)


def test_empty_fcoo_phi_launches_nothing_and_gives_zeros():
    t = PhiTensor(atoms=torch.zeros(0, dtype=torch.int32),
                  voxels=torch.zeros(0, dtype=torch.int32),
                  fibers=torch.zeros(0, dtype=torch.int32),
                  values=torch.zeros(0), n_atoms=3, n_voxels=7, n_fibers=5)
    enc = FcooPhi.encode(t)
    assert enc.n_chunks == 0 and enc.padding_overhead == 0.0
    calls = []
    real = (fcoo.dsc_fcoo, fcoo.wc_fcoo)
    try:
        fcoo.dsc_fcoo = lambda *a, **k: calls.append("dsc")
        fcoo.wc_fcoo = lambda *a, **k: calls.append("wc")
        matvec, rmatvec = ops.make_fcoo_ops(enc, torch.ones(3, 4))
        y, w = matvec(torch.ones(5)), rmatvec(torch.ones(7, 4))
    finally:
        fcoo.dsc_fcoo, fcoo.wc_fcoo = real
    assert calls == []
    assert y.shape == (7, 4) and w.shape == (5,)
    assert not y.any() and not w.any()


# ----------------------------------------------------------------------------
# wrappers: dispatch and operand checks
# ----------------------------------------------------------------------------

def test_format_wrappers_dispatch_by_device_and_check_operands():
    enc, _, o, d, w, y = _sell_pair("ragged", "dsc", "fp32")
    d, w, y = torch.tensor(d), torch.tensor(w), torch.tensor(y)
    before = dict(_build.LAUNCHES)
    args = (o.atoms, o.others, o.values, o.row_nnz, d, w)
    assert torch.equal(dsc.dsc_sell(*args, row_tile=o.row_tile),
                       dsc.dsc_sell_plain(*args, row_tile=o.row_tile))
    assert dict(_build.LAUNCHES) == before           # CPU: no kernel launch
    with pytest.raises(TypeError, match="values has dtype"):
        dsc.dsc_sell(*args[:4], d.to(torch.bfloat16), w, row_tile=o.row_tile)
    with pytest.raises(ValueError, match="multiple of row_tile"):
        dsc.dsc_sell(*args, row_tile=7)
    with pytest.raises(ValueError, match="shape"):
        wc.wc_sell(o.atoms, o.others, o.values, o.row_nnz, d, y[:, :5])
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        dsc.dsc_sell(*meta, row_tile=o.row_tile)

    _, _, f, d2, w2, y2 = _fcoo_pair("ragged", "fp32")
    d2, w2, y2 = torch.tensor(d2), torch.tensor(w2), torch.tensor(y2)
    with pytest.raises(ValueError, match="seg_k"):
        fcoo.dsc_fcoo(f.atoms, f.fibers, f.values, f.dsc_ranks, d2, w2,
                      seg_k=0)
    with pytest.raises(ValueError, match="contiguous"):
        fcoo.wc_fcoo(f.wc_perm.t().contiguous().t(), f.atoms.reshape(-1),
                     f.voxels.reshape(-1), f.values.reshape(-1), f.wc_ranks,
                     d2, y2, seg_k=f.k_wc)
    with pytest.raises(ValueError, match="is on"):
        fcoo.wc_fcoo(f.wc_perm, f.atoms.reshape(-1), f.voxels.reshape(-1),
                     f.values.reshape(-1), f.wc_ranks, d2, y2.to("meta"),
                     seg_k=f.k_wc)
    with pytest.raises(ValueError, match="op="):
        ops.make_dsc_sell(SellPhi.encode(PhiTensor(
            atoms=o.atoms[:0, 0], voxels=o.atoms[:0, 0],
            fibers=o.atoms[:0, 0], values=o.values[:0, 0], n_atoms=1,
            n_voxels=1, n_fibers=1), op="wc"), d)


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

def _on_card(compute_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, t = _phi(3000, 40, 500, 300, seed=10, hot=200, skip=np.r_[8:16])
    t = t.to("cuda")
    d = ops.storage_cast(torch.tensor(_inputs(40, 1, 1, 96, 0)[0]).cuda(),
                         compute_dtype)
    return t, d, torch.rand(300, device="cuda"), torch.randn(500, 96,
                                                             device="cuda")


def _held_to_plain(name, kernel, plain, compute_dtype):
    n = _build.launches(name)
    got = kernel()
    torch.cuda.synchronize()
    assert _build.launches(name) == n + 1
    torch.testing.assert_close(got, plain(), **TOL[compute_dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
def test_dsc_sell_kernel_matches_plain_on_card(compute_dtype):
    t, d, w, _ = _on_card(compute_dtype)
    o = ops.sell_operands(SellPhi.encode(t, op="dsc"), "cuda",
                          compute_dtype=compute_dtype)
    args = (o.atoms, o.others, o.values, o.row_nnz, d, w)
    _held_to_plain("dsc_sell", lambda: dsc.dsc_sell(*args, row_tile=8),
                   lambda: dsc.dsc_sell_plain(*args, row_tile=8),
                   compute_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
def test_wc_sell_kernel_matches_plain_on_card(compute_dtype):
    t, d, _, y = _on_card(compute_dtype)
    o = ops.sell_operands(SellPhi.encode(t, op="wc"), "cuda",
                          compute_dtype=compute_dtype)
    args = (o.atoms, o.others, o.values, o.row_nnz, d, y)
    _held_to_plain("wc_sell", lambda: wc.wc_sell(*args),
                   lambda: wc.wc_sell_plain(*args), compute_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
def test_dsc_fcoo_kernel_matches_plain_on_card(compute_dtype):
    t, d, w, _ = _on_card(compute_dtype)
    o = ops.fcoo_operands(FcooPhi.encode(t, c_tile=64), "cuda",
                          compute_dtype=compute_dtype)
    args = (o.atoms, o.fibers, o.values, o.dsc_ranks, d, w)
    _held_to_plain("dsc_fcoo", lambda: fcoo.dsc_fcoo(*args, seg_k=o.k_dsc),
                   lambda: fcoo.dsc_fcoo_plain(*args, seg_k=o.k_dsc),
                   compute_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
def test_wc_fcoo_kernel_matches_plain_on_card(compute_dtype):
    t, d, _, y = _on_card(compute_dtype)
    o = ops.fcoo_operands(FcooPhi.encode(t, c_tile=64), "cuda",
                          compute_dtype=compute_dtype)
    args = (o.wc_perm, o.atoms.reshape(-1), o.voxels.reshape(-1),
            o.values.reshape(-1), o.wc_ranks, d, y)
    _held_to_plain("wc_fcoo", lambda: fcoo.wc_fcoo(*args, seg_k=o.k_wc),
                   lambda: fcoo.wc_fcoo_plain(*args, seg_k=o.k_wc),
                   compute_dtype)
