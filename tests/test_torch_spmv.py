"""Port vs reference: the plain SpMV executors, restructuring and the
inspector, on the CPU with the same numpy-made inputs.

Where duplicate runs are long, fp32 sums taken in two orders can differ by
more than the conformance bound (ROADMAP §C), so those cases are held to a
float64 oracle with a tolerance scaled by the sum of |terms| per output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inspector as jinspector
from repro.core import restructure as jrestructure
from repro.core import spmv as jspmv
from repro_torch.bridge import from_reference, to_numpy
from repro_torch.core import inspector, restructure, spmv
from repro_torch.core.std import PhiTensor

FP32 = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(p):
    ph = p.phi
    return from_reference(ph.atoms, ph.voxels, ph.fibers, ph.values,
                          ph.n_atoms, ph.n_voxels, ph.n_fibers, p.dictionary,
                          p.b, p.w_true, device="cpu")


def _arrays(nc, na, nv, nf, seed, hot=0):
    """Hand-made Phi arrays (tests/test_kernels.py:_problem) plus ``hot``
    duplicate coefficients on voxel 2 / fiber 1 (long duplicate runs)."""
    r = np.random.default_rng(seed)
    a = np.concatenate([r.integers(0, na, nc), r.integers(0, na, hot)])
    v = np.concatenate([r.integers(0, nv, nc), np.full(hot, 2)])
    f = np.concatenate([r.integers(0, nf, nc), np.full(hot, 1)])
    vals = r.normal(size=nc + hot)
    return a, v, f, vals


def _phi(a, v, f, vals, na, nv, nf):
    return PhiTensor(atoms=torch.tensor(a, dtype=torch.int32),
                     voxels=torch.tensor(v, dtype=torch.int32),
                     fibers=torch.tensor(f, dtype=torch.int32),
                     values=torch.tensor(vals, dtype=torch.float32),
                     n_atoms=na, n_voxels=nv, n_fibers=nf)


# (port dsc, port wc, reference dsc, reference wc, sort dims for (dsc, wc))
OPS = {
    "naive": (spmv.dsc_naive, spmv.wc_naive, jspmv.dsc_naive, jspmv.wc_naive,
              (None, None)),
    "sorted": (spmv.dsc, spmv.wc, jspmv.dsc, jspmv.wc, ("voxel", "fiber")),
    "atom_sorted": (spmv.dsc_atom_sorted, spmv.wc_atom_sorted,
                    jspmv.dsc_atom_sorted, jspmv.wc_atom_sorted,
                    ("atom", "atom")),
}


def _sorted(phi_t, phi_j, dim):
    if dim is None:
        return phi_t, phi_j
    return (restructure.sort_by_host(phi_t, dim)[0],
            jrestructure.sort_by_host(phi_j, dim)[0])


@pytest.mark.parametrize("ops", sorted(OPS))
def test_ops_match_reference_on_tiny_problem(ops, tiny_problem, rng):
    dsc_t, wc_t, dsc_j, wc_j, (dim_d, dim_w) = OPS[ops]
    p = tiny_problem
    tp = _port(p)
    n_theta = p.dictionary.shape[1]
    w = rng.uniform(0, 1, p.phi.n_fibers).astype(np.float32)
    y = rng.normal(size=(p.phi.n_voxels, n_theta)).astype(np.float32)
    pt, pj = _sorted(tp.phi, p.phi, dim_d)
    np.testing.assert_allclose(
        to_numpy(dsc_t(pt, tp.dictionary, torch.tensor(w))),
        np.asarray(dsc_j(pj, p.dictionary, jnp.asarray(w))), **FP32)
    pt, pj = _sorted(tp.phi, p.phi, dim_w)
    np.testing.assert_allclose(
        to_numpy(wc_t(pt, tp.dictionary, torch.tensor(y))),
        np.asarray(wc_j(pj, p.dictionary, jnp.asarray(y))), **FP32)


@pytest.mark.parametrize("ops", sorted(OPS))
@pytest.mark.parametrize("nc,nv,nf,hot", [(50, 40, 30, 0), (513, 100, 64, 0),
                                          (400, 17, 23, 300)])
def test_ops_against_float64_oracle(ops, nc, nv, nf, hot):
    """Hand-made Phi (with a long duplicate run when ``hot``): each output
    within 1e-6 x (sum of |terms|) + 1e-6 of a float64 oracle."""
    dsc_t, wc_t, _, _, (dim_d, dim_w) = OPS[ops]
    na, n_theta = 12, 8
    a, v, f, vals = _arrays(nc, na, nv, nf, seed=nc + hot, hot=hot)
    phi = _phi(a, v, f, vals, na, nv, nf)
    r = np.random.default_rng(1)
    d = r.normal(size=(na, n_theta)).astype(np.float32)
    w = r.uniform(size=nf).astype(np.float32)
    y = r.normal(size=(nv, n_theta)).astype(np.float32)
    vals32 = vals.astype(np.float32).astype(np.float64)

    terms = d[a].astype(np.float64) * (w[f] * vals32)[:, None]
    want_y = np.zeros((nv, n_theta))
    np.add.at(want_y, v, terms)
    mag_y = np.zeros((nv, n_theta))
    np.add.at(mag_y, v, np.abs(terms))
    pt = restructure.sort_by_host(phi, dim_d)[0] if dim_d else phi
    got_y = to_numpy(dsc_t(pt, torch.tensor(d), torch.tensor(w)))
    assert np.all(np.abs(got_y - want_y) <= 1e-6 * mag_y + 1e-6)

    dterms = (d[a].astype(np.float64) * y[v]).sum(1) * vals32
    want_w = np.zeros(nf)
    np.add.at(want_w, f, dterms)
    mag_w = np.zeros(nf)
    np.add.at(mag_w, f, np.abs(d[a].astype(np.float64) * y[v]).sum(1)
              * np.abs(vals32))
    pt = restructure.sort_by_host(phi, dim_w)[0] if dim_w else phi
    got_w = to_numpy(wc_t(pt, torch.tensor(d), torch.tensor(y)))
    assert np.all(np.abs(got_w - want_w) <= 1e-6 * mag_w + 1e-6)


def test_segment_sum_sorted_zero_length_runs():
    ids = torch.tensor([0, 0, 2, 2, 2, 5], dtype=torch.int32)
    data = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    lengths = spmv.segment_lengths(ids, 7)
    assert lengths.tolist() == [2, 0, 3, 0, 0, 1, 0]
    got = spmv.segment_sum_sorted(data, lengths)
    want = torch.zeros(7, 2).index_add_(0, ids, data)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dim", restructure.SORT_DIMS)
def test_sort_by_host_matches_reference(dim, tiny_problem):
    tp = _port(tiny_problem)
    got, order = restructure.sort_by_host(tp.phi, dim)
    want, jorder = jrestructure.sort_by_host(tiny_problem.phi, dim)
    np.testing.assert_array_equal(order, jorder)
    for name in ("atoms", "voxels", "fibers", "values"):
        np.testing.assert_array_equal(to_numpy(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    ids = to_numpy(getattr(got, dim + "s"))
    np.testing.assert_array_equal(restructure.segment_starts(ids),
                                  jrestructure.segment_starts(ids))


def test_compact_by_weight_matches_reference(tiny_problem, rng):
    tp = _port(tiny_problem)
    w = rng.uniform(-1, 1, tiny_problem.phi.n_fibers).astype(np.float32)
    for threshold in (0.0, 0.3):
        got = restructure.compact_by_weight(tp.phi, torch.tensor(w), threshold)
        want = jrestructure.compact_by_weight(tiny_problem.phi,
                                              jnp.asarray(w), threshold)
        assert 0 < got.n_coeffs < tp.phi.n_coeffs
        np.testing.assert_array_equal(to_numpy(got.fibers),
                                      np.asarray(want.fibers))
        np.testing.assert_array_equal(to_numpy(got.values),
                                      np.asarray(want.values))


@pytest.mark.parametrize("nc,n_rows,c_tile,row_tile", [
    (0, 10, 8, 4), (50, 40, 16, 4), (513, 100, 64, 8), (1000, 17, 128, 8),
    (7, 300, 32, 16)])
def test_plan_tiles_copy_matches_reference(nc, n_rows, c_tile, row_tile):
    ids = np.sort(np.random.default_rng(nc).integers(0, n_rows, nc))
    got = inspector.plan_tiles(ids, n_rows, c_tile=c_tile, row_tile=row_tile)
    want = jinspector.plan_tiles(ids, n_rows, c_tile=c_tile,
                                 row_tile=row_tile)
    for name in ("sel", "row_block", "local_row"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for name in ("n_tiles", "c_tile", "row_tile", "n_rows_padded",
                 "n_coeffs", "n_padded"):
        assert getattr(got, name) == getattr(want, name)
    assert got.occupancy() == want.occupancy()
    assert inspector.auto_tile(ids, n_rows) == jinspector.auto_tile(ids,
                                                                    n_rows)
    np.testing.assert_array_equal(inspector.run_lengths(ids),
                                  jinspector.run_lengths(ids))


def test_plan_tiles_rejects_unsorted_and_out_of_range():
    with pytest.raises(ValueError, match="sorted"):
        inspector.plan_tiles(np.array([3, 1]), 4, c_tile=8, row_tile=2)
    with pytest.raises(ValueError, match="out of range"):
        inspector.plan_tiles(np.array([1, 9]), 4, c_tile=8, row_tile=2)
