"""Port vs reference: STD data types, the synthetic generator and the bridge.

The same numpy-made inputs go through the JAX package and the port on the
CPU; the reference's problems reach the port through repro_torch.bridge.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import std as jstd
from repro.data.dmri import synth_connectome as jsynth
from repro_torch.bridge import from_reference, to_numpy, weights_from_reference
from repro_torch.core import std
from repro_torch.data.dmri import TRACTOGRAPHY, synth_connectome
from repro_torch.device import resolve_device


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
                          p.b, p.w_true, device="cpu", grid=p.grid)


def test_materialize_dense_matches_reference(tiny_problem, tiny_dense):
    tp = _port(tiny_problem)
    got = to_numpy(std.materialize_dense(tp.phi, tp.dictionary))
    np.testing.assert_allclose(got, np.asarray(tiny_dense), rtol=2e-6,
                               atol=1e-7)


@pytest.mark.parametrize("algorithm", sorted(TRACTOGRAPHY))
def test_synth_phi_equals_reference_array_for_array(algorithm):
    """Same seed, same numpy stream: Phi and w_true equal the reference's
    exactly; with the reference's dictionary carried across, b agrees to
    fp32 rounding (the scatter-adds sum in another order)."""
    kw = dict(n_fibers=24, n_theta=12, n_atoms=16, grid=(8, 8, 8),
              algorithm=algorithm, seed=5)
    ref = jsynth(**kw)
    got = synth_connectome(**kw, device="cpu",
                           dictionary=torch.tensor(np.asarray(ref.dictionary)))
    for name in ("atoms", "voxels", "fibers", "values"):
        np.testing.assert_array_equal(to_numpy(getattr(got.phi, name)),
                                      np.asarray(getattr(ref.phi, name)),
                                      err_msg=name)
    assert (got.phi.n_atoms, got.phi.n_voxels, got.phi.n_fibers) == (
        ref.phi.n_atoms, ref.phi.n_voxels, ref.phi.n_fibers)
    np.testing.assert_array_equal(to_numpy(got.w_true), np.asarray(ref.w_true))
    np.testing.assert_allclose(to_numpy(got.b), np.asarray(ref.b),
                               rtol=1e-5, atol=1e-6)
    assert got.stats == ref.stats and got.grid == ref.grid


def test_bridge_round_trip(tiny_problem):
    p = tiny_problem
    tp = _port(p)
    for ours, theirs in ((tp.phi.atoms, p.phi.atoms),
                         (tp.phi.voxels, p.phi.voxels),
                         (tp.phi.fibers, p.phi.fibers),
                         (tp.phi.values, p.phi.values),
                         (tp.dictionary, p.dictionary), (tp.b, p.b),
                         (tp.w_true, p.w_true)):
        np.testing.assert_array_equal(to_numpy(ours), np.asarray(theirs))
    assert tp.phi.atoms.dtype == torch.int32
    assert tp.phi.values.dtype == torch.float32
    assert tp.stats == p.stats
    w = np.random.default_rng(0).uniform(size=p.phi.n_fibers).astype(np.float32)
    np.testing.assert_array_equal(
        to_numpy(weights_from_reference(jnp.asarray(w), device="cpu")), w)
    half = torch.tensor([1.5, -2.0], dtype=torch.bfloat16)
    assert to_numpy(half).dtype == np.float32


def test_bridge_rejects_out_of_range_indices(tiny_problem):
    ph = tiny_problem.phi
    atoms = np.asarray(ph.atoms).copy()
    atoms[0] = ph.n_atoms
    with pytest.raises(ValueError, match="atom index"):
        from_reference(atoms, ph.voxels, ph.fibers, ph.values, ph.n_atoms,
                       ph.n_voxels, ph.n_fibers, tiny_problem.dictionary,
                       tiny_problem.b, tiny_problem.w_true, device="cpu")


def test_phi_take_astype_to(tiny_problem):
    tp = _port(tiny_problem).phi
    order = np.random.default_rng(3).permutation(tp.n_coeffs)
    want = tiny_problem.phi.take(jnp.asarray(order))
    got = tp.take(order)
    for name in ("atoms", "voxels", "fibers", "values"):
        np.testing.assert_array_equal(to_numpy(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    assert tp.astype(torch.bfloat16).values.dtype == torch.bfloat16
    assert tp.to("cpu").atoms is tp.atoms
    assert tp.n_coeffs == tiny_problem.phi.n_coeffs


def test_demean_signal_matches_reference():
    y = np.random.default_rng(4).normal(size=(30, 12)).astype(np.float32)
    want = np.asarray(jstd.demean_signal(jnp.asarray(y), 12))
    got = to_numpy(std.demean_signal(torch.tensor(y), 12))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_fibonacci_sphere_and_dictionary_construction():
    """The atom directions are the reference's; the dictionary is built the
    same way from the same gradient directions (the reference's JAX draw,
    reproduced by repro_torch.core.prng), so it equals the reference's to
    float32 rounding, and every atom is demeaned."""
    np.testing.assert_array_equal(std._fibonacci_sphere(17),
                                  jstd._fibonacci_sphere(17))
    d = std.make_dictionary(16, 12, device="cpu")
    assert d.shape == (16, 12) and d.dtype == torch.float32
    assert d.is_contiguous()
    np.testing.assert_allclose(to_numpy(d).mean(axis=1), 0.0, atol=1e-6)
    again = std.make_dictionary(16, 12, device="cpu")
    assert torch.equal(d, again)
    np.testing.assert_allclose(to_numpy(d), np.asarray(jstd.make_dictionary(16, 12)),
                               rtol=1e-5, atol=1e-6)


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device asked for, entry points want the CUDA card and raise
    without one; they never fall back to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synth_connectome(n_fibers=4, grid=(6, 6, 6))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        std.make_dictionary(4, 4)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("helper", ["tunable_executors", "sort_by",
                                    "matvec_dense_oracle",
                                    "rmatvec_dense_oracle", "fmt_bytes"])
def test_public_helpers_match_the_reference(tiny_problem, helper):
    """The small public helpers the port keeps beside the reference's:
    the tuner's executor list, the on-device stable sort (phi and
    permutation, each dimension), the dense oracles and the report's
    byte format."""
    from repro import tune as jtune
    from repro.core import restructure as jrs
    from repro.core import spmv as jspmv
    from repro.roofline import report as jreport
    from repro_torch import tune
    from repro_torch.core import restructure as rs
    from repro_torch.core import spmv
    from repro_torch.roofline import report
    if helper == "tunable_executors":
        assert tune.tunable_executors() == jtune.tunable_executors()
    elif helper == "sort_by":
        tp = _port(tiny_problem)
        for dim in ("atom", "voxel", "fiber"):
            got, order = rs.sort_by(tp.phi, dim)
            want, jorder = jrs.sort_by(tiny_problem.phi, dim)
            np.testing.assert_array_equal(to_numpy(order), np.asarray(jorder))
            for a in ("atoms", "voxels", "fibers", "values"):
                np.testing.assert_array_equal(to_numpy(getattr(got, a)),
                                              np.asarray(getattr(want, a)))
    elif helper == "fmt_bytes":
        for b in (0.0, 1.0, 123456789.0, 2.5e12):
            assert report.fmt_bytes(b) == jreport.fmt_bytes(b)
    else:
        r = np.random.default_rng(3)
        m = r.normal(size=(7, 5)).astype(np.float32)
        v = r.normal(size=(5 if helper == "matvec_dense_oracle" else 7,)
                     ).astype(np.float32)
        got = getattr(spmv, helper)(torch.from_numpy(m), torch.from_numpy(v))
        want = getattr(jspmv, helper)(jnp.asarray(m), jnp.asarray(v))
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
