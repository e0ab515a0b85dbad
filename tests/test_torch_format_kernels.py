"""Port vs reference: the format kernels B3 (SELL DSC), B4 (SELL WC), B5
(F-COO DSC) and B6 (F-COO WC).

On the CPU the wrappers run their kernels' plain PyTorch versions.  These
tests hold the plain versions against the reference's Pallas kernels run
in interpret mode on the same operands (as tests/test_formats.py and
tests/test_fcoo.py run them), B5's and B6's segment partials included,
zeros and all, and B5's fused ``y = M w`` and B6's fused ``w = Mᵀ y``
against the reference's F-COO matvec and rmatvec (kernel plus
scatter-add); they hold the F-COO ops to a float64 oracle with a tolerance
scaled by the sum of |terms| per output (fp32 sums in two orders differ by
more than a fixed bound on long duplicate runs, ROADMAP §C) on the cases
the carries of B5 and B6 exist for; and they check the wrappers' dispatch
and operand checks.  The CUDA kernels
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
    got = ops.fcoo_dsc_partials(enc, o, dt, torch.tensor(w))
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
def test_dsc_fcoo_fused_matches_reference_matvec(case, compute_dtype):
    """B5's fused y = M w (its plain version: interior stores, carries, an
    ordered fold) equals the reference's F-COO matvec, the Pallas kernel's
    partials scatter-added over seg_rows_dsc, on the same encoded Phi."""
    enc, jenc, o, d, w, _ = _fcoo_pair(case, compute_dtype)
    dt = ops.storage_cast(torch.tensor(d), compute_dtype)
    got = fcoo.dsc_fcoo(o.atoms, o.fibers, o.values, o.voxels, dt,
                        torch.tensor(w), n_voxels=o.n_voxels)
    matvec, _ = jops.make_fcoo_ops(jenc, jnp.asarray(d), interpret=True,
                                   compute_dtype=compute_dtype)
    want = np.asarray(matvec(jnp.asarray(w)))
    assert got.shape == (enc.n_voxels, d.shape[1]) == want.shape
    np.testing.assert_allclose(to_numpy(got), want, **TOL[compute_dtype])
    # and the partials folded by the port's own combine
    folded = ops.fcoo_dsc_folded(enc, o, dt, torch.tensor(w))
    np.testing.assert_allclose(to_numpy(got), to_numpy(folded), **FP32)


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", SHAPES)
def test_wc_fcoo_partials_match_pallas_kernel(case, compute_dtype):
    """B6's (n_chunks, K) partials, read through wc_perm, equal the Pallas
    kernel's over the reference's pre-gathered view."""
    enc, jenc, o, d, _, y = _fcoo_pair(case, compute_dtype)
    dt = ops.storage_cast(torch.tensor(d), compute_dtype)
    got = ops.fcoo_wc_partials(enc, o, dt, torch.tensor(y))
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


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", SHAPES)
def test_wc_fcoo_fused_matches_reference_rmatvec(case, compute_dtype):
    """B6's fused w = Mᵀ y (its plain version: interior stores, carries, an
    ordered fold) equals the reference's F-COO rmatvec, the Pallas kernel's
    partials scatter-added over seg_rows_wc, on the same encoded Phi."""
    enc, jenc, o, d, _, y = _fcoo_pair(case, compute_dtype)
    dt = ops.storage_cast(torch.tensor(d), compute_dtype)
    got = fcoo.wc_fcoo(o.wc_perm, o.wc_fibers, o.atoms.reshape(-1),
                       o.voxels.reshape(-1), o.values.reshape(-1), dt,
                       torch.tensor(y), n_fibers=o.n_fibers)
    _, rmatvec = jops.make_fcoo_ops(jenc, jnp.asarray(d), interpret=True,
                                    compute_dtype=compute_dtype)
    want = np.asarray(rmatvec(jnp.asarray(y)))
    assert got.shape == (enc.n_fibers,) == want.shape
    np.testing.assert_allclose(to_numpy(got), want, **TOL[compute_dtype])
    # and the partials folded by the port's own combine
    folded = ops.fcoo_wc_folded(enc, o, dt, torch.tensor(y))
    np.testing.assert_allclose(to_numpy(got), to_numpy(folded), **FP32)


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


def _line_phi(voxels, fibers, n_voxels, n_fibers, n_atoms=4):
    """A Phi whose coefficients lie on the given voxel and fiber ids."""
    n = len(voxels)
    return PhiTensor(atoms=torch.arange(n, dtype=torch.int32) % n_atoms,
                     voxels=torch.tensor(voxels, dtype=torch.int32),
                     fibers=torch.tensor(fibers, dtype=torch.int32),
                     values=torch.linspace(-1, 1, n), n_atoms=n_atoms,
                     n_voxels=n_voxels, n_fibers=n_fibers)


def _oracle_case(case):
    """(Phi, c_tile) of each edge of the F-COO fold."""
    if case == "run-across-chunks":
        # ~130 duplicate triples on voxel 3 / fiber 5 span several chunks
        return _phi(300, 6, 40, 20, seed=11, hot=130)[1], 32
    if case == "chunk-at-k-limit":
        # every slot its own segment: a chunk holds c_tile segments, K's
        # largest value
        nv = 64
        return _line_phi(np.arange(nv), np.arange(nv)[::-1].copy(), nv,
                         nv), 32
    if case == "run-across-three-chunks":
        # voxel 5's run fills chunks 1 and 2 and spills into 0 and 3: two
        # chunks of one segment, each carrying it first and last
        v = np.r_[0:5, np.full(100, 5), 6:20]
        return _line_phi(v, np.arange(v.size) % 7, 24, 7), 32
    if case == "run-starts-at-chunk-boundary":
        # voxel 9's run starts in slot 0 of chunk 1 and voxel 26's run ends
        # in its last slot
        v = np.r_[np.repeat(np.arange(8), 4), np.full(10, 9), 10:26,
                  np.full(6, 26), np.repeat(np.arange(27, 43), 2)]
        return _line_phi(v, np.arange(v.size) % 11, 50, 11), 32
    if case == "one-chunk":
        # fewer coefficients than c_tile: one chunk, padded
        v = np.r_[2, 2, 5, 7, 7, 7, 11]
        return _line_phi(v, np.arange(v.size), 13, 8), 32
    # voxels and fibers with no coefficient: gaps inside chunks, between
    # chunks, before the first and after the last
    v = np.r_[np.full(20, 4), np.arange(30, 60) * 2, np.full(18, 150)]
    return _line_phi(v, 1 + 2 * (np.arange(v.size) % 9), 170, 20), 32


@pytest.mark.parametrize("case", ["run-across-chunks", "chunk-at-k-limit",
                                  "run-across-three-chunks",
                                  "run-starts-at-chunk-boundary", "one-chunk",
                                  "empty-voxels"])
def test_fcoo_ops_match_float64_oracle(case):
    t, c_tile = _oracle_case(case)
    enc = FcooPhi.encode(t, c_tile=c_tile, seg_tile=4)
    ranks = enc.dsc_ranks.reshape(enc.n_chunks, c_tile)
    voxels = enc.voxels.reshape(enc.n_chunks, c_tile)
    if case == "run-across-chunks":          # voxel 3 and fiber 5 each
        assert sum(3 in r for r in enc.seg_rows_dsc) > 1     # span chunks
        assert sum(5 in r for r in enc.seg_rows_wc) > 1
    elif case == "chunk-at-k-limit":
        assert enc.k_dsc == enc.k_wc == c_tile
    elif case == "run-across-three-chunks":
        assert sum(5 in r for r in enc.seg_rows_dsc) >= 3
        assert (ranks[:, -1] == 0).sum() >= 2   # chunks of one segment
    elif case == "run-starts-at-chunk-boundary":
        assert voxels[1, 0] == 9 and voxels[0, -1] != 9
        assert voxels[1, -1] == 26 and voxels[2, 0] != 26
    elif case == "one-chunk":
        assert enc.n_chunks == 1
    else:
        for ids, n in ((t.voxels, t.n_voxels), (t.fibers, t.n_fibers)):
            present = np.unique(ids.numpy())
            assert present[0] > 0 and present[-1] < n - 1
            assert np.diff(present).max() > 1
    d, w, y = _inputs(t.n_atoms, t.n_voxels, t.n_fibers, 8, seed=12)
    matvec, rmatvec = ops.make_fcoo_ops(enc, torch.tensor(d))
    ym, ys, wm, ws = _oracle(t, d, w, y)
    eps = 8 * np.finfo(np.float32).eps
    got_y = to_numpy(matvec(torch.tensor(w))).astype(np.float64)
    got_w = to_numpy(rmatvec(torch.tensor(y))).astype(np.float64)
    assert np.all(np.abs(got_y - ym) <= eps * ys + 1e-12)
    assert np.all(np.abs(got_w - wm) <= eps * ws + 1e-12)
    empty = np.setdiff1d(np.arange(t.n_voxels), t.voxels.numpy())
    assert not got_y[empty].any()
    # fibers with no coefficient come out exactly 0
    empty = np.setdiff1d(np.arange(t.n_fibers), t.fibers.numpy())
    assert np.all(got_w[empty] == 0.0)


# ----------------------------------------------------------------------------
# B4: the fiber-row SELL layout it walks, its plain version vs float64
# ----------------------------------------------------------------------------

#: real slots of each fiber row of the B4 edge case: empty rows, rows of
#: more than one batch of 32, and (8 rows per warp) a first batch over rows
#: 0, 2, 3 and 4 and a second that finishes row 4 and spans rows 6 and 7;
#: 13 fibers padded to 16 rows
B4_EDGE_NNZ = (2, 0, 1, 3, 40, 0, 5, 1, 0, 70, 2, 0, 33)


def _b4_edge_phi():
    nnz = np.asarray(B4_EDGE_NNZ)
    f = np.repeat(np.arange(nnz.size), nnz)
    r = np.random.default_rng(21)
    n = f.size
    return PhiTensor(atoms=torch.tensor(r.integers(0, 6, n), dtype=torch.int32),
                     voxels=torch.tensor(r.integers(0, 30, n),
                                         dtype=torch.int32),
                     fibers=torch.tensor(f, dtype=torch.int32),
                     values=torch.tensor(r.normal(size=n), dtype=torch.float32),
                     n_atoms=6, n_voxels=30, n_fibers=nnz.size)


def _b4_case(case):
    """(Phi, row_tile, slot_tile) of a B4 test case."""
    if case == "edges":
        return _b4_edge_phi(), 8, 32
    if case == "hot-fiber":        # ~130 duplicates on fiber 5
        return _phi(300, 6, 40, 20, seed=11, hot=130)[1], 8, 32
    nc, na, nv, nf, hot, skip, _, rt, st, _ = SHAPES[case]
    return _phi(nc, na, nv, nf, seed=nc, hot=hot, skip=skip)[1], rt, st


@pytest.mark.parametrize("case", ["edges", "hot-fiber", *SHAPES])
def test_wc_sell_layout_holds_what_b4_walks(case):
    """B4 reads only row r's prefix [0, row_nnz[r]) of the fiber-row SELL
    arrays and finds rows from row_nnz alone: each row's real slots are
    that prefix and hold the fiber's coefficients, padding slots hold
    index 0 and value 0, the shape is a (row_tile, slot_tile) multiple and
    row_nnz counts every coefficient once."""
    t, rt, st = _b4_case(case)
    enc = SellPhi.encode(t, op="wc", row_tile=rt, slot_tile=st)
    rows_padded, width = enc.atoms.shape
    assert rows_padded % rt == 0 and width % st == 0
    assert rows_padded >= enc.n_rows == enc.row_nnz.size == t.n_fibers
    assert enc.row_nnz.sum() == t.atoms.numel()
    nnz = np.zeros(rows_padded, np.int64)
    nnz[:enc.n_rows] = enc.row_nnz
    real = np.arange(width)[None, :] < nnz[:, None]
    assert not enc.atoms[~real].any() and not enc.others[~real].any()
    assert not enc.values[~real].any()
    f = t.fibers.numpy()
    for r in range(enc.n_rows):
        got = sorted(zip(enc.atoms[r, :nnz[r]], enc.others[r, :nnz[r]],
                         enc.values[r, :nnz[r]]))
        mine = f == r
        want = sorted(zip(t.atoms.numpy()[mine], t.voxels.numpy()[mine],
                          t.values.numpy()[mine]))
        assert got == want
    if case == "edges":
        assert rows_padded - enc.n_rows == 3
        assert (enc.row_nnz == 0).sum() == 4 and (enc.row_nnz > 32).sum() == 3


@pytest.mark.parametrize("case", ["edges", "hot-fiber", *SHAPES])
def test_wc_sell_plain_matches_float64_oracle(case):
    """B4's plain version against float64 on the edges B4 walks (empty
    rows, rows of more than 32 slots, padding rows, a hot fiber), within
    8 eps of the sum of |terms| per fiber; empty and padding rows exactly
    0."""
    t, rt, st = _b4_case(case)
    enc = SellPhi.encode(t, op="wc", row_tile=rt, slot_tile=st)
    o = ops.sell_operands(enc, "cpu")
    d, w, y = _inputs(t.n_atoms, t.n_voxels, t.n_fibers, 12, seed=13)
    got = to_numpy(wc.wc_sell_plain(o.atoms, o.others, o.values, o.row_nnz,
                                    torch.tensor(d), torch.tensor(y)))
    _, _, wm, ws = _oracle(t, d, w, y)
    assert got.shape == (enc.atoms.shape[0],)
    eps = 8 * np.finfo(np.float32).eps
    assert np.all(np.abs(got[:t.n_fibers] - wm) <= eps * ws + 1e-12)
    assert not got[t.n_fibers:].any()
    assert np.all(got[:t.n_fibers][enc.row_nnz == 0] == 0.0)


def test_wc_sell_probe_builds_each_variant_from_the_tree():
    """The B4 probe's variants are the tree's sources with one change each:
    the launch shape, or batches that stop at each row's end."""
    from repro_torch.tune import probe_wc_sell as probe
    cu = (_build.CSRC / "wc_sell.cu").read_text()
    cuh = (_build.CSRC / "common.cuh").read_text()
    v = probe.variants()
    assert sorted(v) == sorted([*probe.SHAPES, "per_row"])
    for name, (threads, blocks) in probe.SHAPES.items():
        assert v[name][1] == cuh and v[name][0] != cu
        assert f"__launch_bounds__(kThreads, {blocks})" in v[name][0]
        assert f"constexpr int kThreads = {threads};" in v[name][0]
    assert v["per_row"][0] == cu and "row_end - pos_" in v["per_row"][1]
    assert "row_end - pos_" not in cuh


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
    out = dsc.dsc_sell(*meta, row_tile=o.row_tile)    # a trace's op
    assert out.is_meta and out.shape == (o.atoms.shape[0], d.shape[1])
    assert dict(_build.LAUNCHES) == before
    with pytest.raises(ValueError, match="is on"):
        dsc.dsc_sell(*meta[:-1], w, row_tile=o.row_tile)

    _, _, f, d2, w2, y2 = _fcoo_pair("ragged", "fp32")
    d2, w2, y2 = torch.tensor(d2), torch.tensor(w2), torch.tensor(y2)
    with pytest.raises(ValueError, match="n_voxels"):
        fcoo.dsc_fcoo(f.atoms, f.fibers, f.values, f.voxels, d2, w2,
                      n_voxels=-1)
    stream = (f.atoms.reshape(-1), f.voxels.reshape(-1),
              f.values.reshape(-1))
    with pytest.raises(ValueError, match="n_fibers"):
        fcoo.wc_fcoo(f.wc_perm, f.wc_fibers, *stream, d2, y2, n_fibers=-1)
    with pytest.raises(ValueError, match="contiguous"):
        fcoo.wc_fcoo(f.wc_perm.t().contiguous().t(), f.wc_fibers, *stream,
                     d2, y2, n_fibers=f.n_fibers)
    with pytest.raises(ValueError, match="is on"):
        fcoo.wc_fcoo(f.wc_perm, f.wc_fibers, *stream, d2, y2.to("meta"),
                     n_fibers=f.n_fibers)
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
    """One launch of ``kernel`` against ``plain``; a second launch is
    bit-identical (no atomics, one summation order).  Returns the first."""
    n = _build.launches(name)
    got = kernel()
    torch.cuda.synchronize()
    assert _build.launches(name) == n + 1
    torch.testing.assert_close(got, plain(), **TOL[compute_dtype])
    assert torch.equal(got, kernel())
    return got


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
    """The fused B5 against its plain version and against the Pallas-style
    partials folded by the combine; a second launch is bit-identical."""
    t, d, w, _ = _on_card(compute_dtype)
    enc = FcooPhi.encode(t, c_tile=64)
    o = ops.fcoo_operands(enc, "cuda", compute_dtype=compute_dtype)
    args = (o.atoms, o.fibers, o.values, o.voxels, d, w)
    got = _held_to_plain(
        "dsc_fcoo", lambda: fcoo.dsc_fcoo(*args, n_voxels=o.n_voxels),
        lambda: fcoo.dsc_fcoo_fused_plain(*args, n_voxels=o.n_voxels),
        compute_dtype)
    folded = ops.fcoo_dsc_folded(enc, o, d, w)
    torch.testing.assert_close(got, folded, **TOL[compute_dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
def test_wc_fcoo_kernel_matches_plain_on_card(compute_dtype):
    """The fused B6 against its plain version and against the Pallas-style
    partials folded by the combine; a second launch is bit-identical."""
    t, d, _, y = _on_card(compute_dtype)
    enc = FcooPhi.encode(t, c_tile=64)
    o = ops.fcoo_operands(enc, "cuda", compute_dtype=compute_dtype)
    args = (o.wc_perm, o.wc_fibers, o.atoms.reshape(-1),
            o.voxels.reshape(-1), o.values.reshape(-1), d, y)
    got = _held_to_plain(
        "wc_fcoo", lambda: fcoo.wc_fcoo(*args, n_fibers=o.n_fibers),
        lambda: fcoo.wc_fcoo_fused_plain(*args, n_fibers=o.n_fibers),
        compute_dtype)
    folded = ops.fcoo_wc_folded(enc, o, d, y)
    torch.testing.assert_close(got, folded, **TOL[compute_dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("n_atoms", [40, 8192])
@pytest.mark.parametrize("n_theta", [16, 64, 128, 160])
@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
def test_sell_dsc_and_fcoo_wc_at_every_width_on_card(compute_dtype, n_theta,
                                                     n_atoms):
    """B3, B4 and B6 at every width they dispatch on: Ntheta 16, 64 and 128
    take B4's and B6's float4 paths of 1, 2 and 4 vectors and B3's 1, 2 and
    4 columns per lane, 160 B4's and B6's scalar path and B3's two column
    passes; 40 atoms stage D in shared memory, 8192 atoms do not fit
    there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, t = _phi(3000, n_atoms, 500, 300, seed=11, hot=200, skip=np.r_[8:16])
    t = t.to("cuda")
    d32, w, y = _inputs(n_atoms, 500, 300, n_theta, seed=12)
    d = ops.storage_cast(torch.tensor(d32).cuda(), compute_dtype)
    w, y = torch.tensor(w).cuda(), torch.tensor(y).cuda()
    o = ops.sell_operands(SellPhi.encode(t, op="dsc"), "cuda",
                          compute_dtype=compute_dtype)
    args = (o.atoms, o.others, o.values, o.row_nnz, d, w)
    _held_to_plain("dsc_sell", lambda: dsc.dsc_sell(*args, row_tile=8),
                   lambda: dsc.dsc_sell_plain(*args, row_tile=8),
                   compute_dtype)
    o = ops.sell_operands(SellPhi.encode(t, op="wc"), "cuda",
                          compute_dtype=compute_dtype)
    args = (o.atoms, o.others, o.values, o.row_nnz, d, y)
    _held_to_plain("wc_sell", lambda: wc.wc_sell(*args),
                   lambda: wc.wc_sell_plain(*args), compute_dtype)
    o = ops.fcoo_operands(FcooPhi.encode(t, c_tile=64), "cuda",
                          compute_dtype=compute_dtype)
    args = (o.wc_perm, o.wc_fibers, o.atoms.reshape(-1),
            o.voxels.reshape(-1), o.values.reshape(-1), d, y)
    _held_to_plain("wc_fcoo",
                   lambda: fcoo.wc_fcoo(*args, n_fibers=o.n_fibers),
                   lambda: fcoo.wc_fcoo_fused_plain(*args,
                                                    n_fibers=o.n_fibers),
                   compute_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
def test_wc_sell_kernel_edges_on_card(compute_dtype):
    """B4 on B4_EDGE_NNZ's layout: empty fiber rows, rows of more than 32
    slots, padding rows past n_rows and packed batches spanning three and
    more rows, one of which finishes a row that the batch before it left
    open; empty and padding rows exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t = _b4_edge_phi()
    enc = SellPhi.encode(t, op="wc")
    d32, _, y = _inputs(t.n_atoms, t.n_voxels, t.n_fibers, 96, seed=22)
    o = ops.sell_operands(enc, "cuda", compute_dtype=compute_dtype)
    d = ops.storage_cast(torch.tensor(d32).cuda(), compute_dtype)
    args = (o.atoms, o.others, o.values, o.row_nnz, d, torch.tensor(y).cuda())
    got = _held_to_plain("wc_sell", lambda: wc.wc_sell(*args),
                         lambda: wc.wc_sell_plain(*args), compute_dtype)
    empty = np.r_[np.nonzero(enc.row_nnz == 0)[0],
                  np.arange(enc.n_rows, enc.atoms.shape[0])]
    assert torch.count_nonzero(got[empty]) == 0
