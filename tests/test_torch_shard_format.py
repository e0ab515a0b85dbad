"""Port vs reference: the partitioned layout ``formats/shard.py``, the
shard helpers of ``core/inspector.py`` and the shard plan kind of
``core/plan_cache.py``.

The same Phi (the reference's ``tiny_problem`` and small random ones, some
skewed so that an equal-nnz cut lands at offset 0) through both packages:
``partition_cuts``' cuts and ``ShardPhi.encode``'s arrays, ``cell_nnz``,
``nbytes`` and ``padding_overhead`` equal array for array for coo and sell
cells, both ops, at (1, 1), (1, 2), (2, 1), (2, 2) and (4, 2); ``decode``
round-trips the coefficient multiset exactly; padding slots and
zero-valued coefficients are inert (bit for bit, and in float64 within
1e-10 where extra coefficients move the cuts); the numpy oracles
``dsc_reference`` / ``wc_reference`` equal the reference's bit for bit and
agree with the dense oracle within rtol 2e-4 / atol 2e-5; a shard plan
written by either package's cache parses in the other's under one key.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inspector as jinspector
from repro.core.plan_cache import PlanCache as JPlanCache
from repro.core.std import PhiTensor as JPhi
from repro.formats import shard as jshard
from repro_torch.bridge import from_reference
from repro_torch.core import inspector
from repro_torch.core.plan_cache import PlanCache, shard_plan_key
from repro_torch.core.std import PhiTensor
from repro_torch.formats import FORMATS, canonical_triples
from repro_torch.formats import shard

MESHES = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 2)]
GEOM = dict(row_tile=4, slot_tile=8)


def _port(p):
    ph = p.phi
    return from_reference(ph.atoms, ph.voxels, ph.fibers, ph.values,
                          ph.n_atoms, ph.n_voxels, ph.n_fibers, p.dictionary,
                          p.b, p.w_true, device="cpu")


def _random_pair(seed: int, skewed: bool):
    """A small random Phi in both packages (the reference test's
    ``small_phi``: skewed puts 60% of the coefficients on one id per
    mode)."""
    r = np.random.default_rng(seed)
    nc, nv, nf, na = (int(r.integers(1, 400)), int(r.integers(1, 40)),
                      int(r.integers(1, 24)), int(r.integers(1, 8)))
    voxels = r.integers(0, nv, nc)
    fibers = r.integers(0, nf, nc)
    if skewed:
        voxels[: (6 * nc) // 10] = int(r.integers(0, nv))
        fibers[: (6 * nc) // 10] = int(r.integers(0, nf))
    atoms = r.integers(0, na, nc)
    values = r.normal(size=nc).astype(np.float32)
    jphi = JPhi(atoms=jnp.asarray(atoms, jnp.int32),
                voxels=jnp.asarray(voxels, jnp.int32),
                fibers=jnp.asarray(fibers, jnp.int32),
                values=jnp.asarray(values), n_atoms=na, n_voxels=nv,
                n_fibers=nf)
    tphi = PhiTensor(atoms=torch.tensor(atoms, dtype=torch.int32),
                     voxels=torch.tensor(voxels, dtype=torch.int32),
                     fibers=torch.tensor(fibers, dtype=torch.int32),
                     values=torch.tensor(values), n_atoms=na, n_voxels=nv,
                     n_fibers=nf)
    return jphi, tphi


RANDOM = [(seed, skewed) for seed in (0, 1, 2) for skewed in (False, True)]


def _assert_shards_equal(got, want):
    assert (got.op, got.cell_format, got.R, got.C, got.nv_local,
            got.nf_local, got.row_tile, got.slot_tile) == (
        want.op, want.cell_format, want.R, want.C, want.nv_local,
        want.nf_local, want.row_tile, want.slot_tile)
    np.testing.assert_array_equal(got.voxel_cuts, want.voxel_cuts)
    np.testing.assert_array_equal(got.fiber_cuts, want.fiber_cuts)
    assert sorted(got.arrays) == sorted(want.arrays)
    for k in want.arrays:
        assert got.arrays[k].dtype == want.arrays[k].dtype, k
        np.testing.assert_array_equal(got.arrays[k], want.arrays[k],
                                      err_msg=k)
    np.testing.assert_array_equal(got.cell_nnz, want.cell_nnz)
    assert got.nbytes == want.nbytes
    assert got.padding_overhead == want.padding_overhead
    assert got.n_coeffs == want.n_coeffs


def test_inspector_shard_helpers_match_reference():
    r = np.random.default_rng(0)
    for n_shards in (1, 2, 3, 5):
        for ids in (np.sort(r.integers(0, 30, 200)),
                    np.sort(np.r_[np.zeros(150, np.int64),
                                  r.integers(0, 30, 50)]),
                    np.zeros(0, np.int64)):
            if ids.size == 0 and n_shards > 1:
                continue
            got = inspector.shard_boundaries(ids, n_shards)
            np.testing.assert_array_equal(
                got, jinspector.shard_boundaries(ids, n_shards))
            for pad_to in (None, 97):
                a, wa = inspector.pad_shards_equal(got, pad_to)
                b, wb = jinspector.pad_shards_equal(got, pad_to)
                np.testing.assert_array_equal(a, b)
                assert wa == wb
    plan = inspector.ShardPlan(R=2, C=3, voxel_cuts=np.int64([0, 4, 9]),
                               fiber_cuts=np.int64([0, 1, 5, 7]))
    jplan = jinspector.ShardPlan(R=2, C=3, voxel_cuts=plan.voxel_cuts,
                                 fiber_cuts=plan.fiber_cuts)
    assert (plan.nv_local, plan.nf_local) == (jplan.nv_local,
                                              jplan.nf_local) == (5, 4)


@pytest.mark.parametrize("R,C", MESHES)
def test_partition_cuts_match_reference(R, C, tiny_problem):
    got = shard.partition_cuts(_port(tiny_problem).phi, R, C)
    want = jshard.partition_cuts(tiny_problem.phi, R, C)
    np.testing.assert_array_equal(got.voxel_cuts, want.voxel_cuts)
    np.testing.assert_array_equal(got.fiber_cuts, want.fiber_cuts)
    assert (got.R, got.C, got.nv_local, got.nf_local) == (
        want.R, want.C, want.nv_local, want.nf_local)


@pytest.mark.parametrize("R,C", MESHES)
@pytest.mark.parametrize("op", ["dsc", "wc"])
@pytest.mark.parametrize("cell_format", shard.CELL_FORMATS)
def test_encode_matches_reference_array_for_array(cell_format, op, R, C,
                                                   tiny_problem):
    got = shard.ShardPhi.encode(_port(tiny_problem).phi, op=op,
                                cell_format=cell_format, R=R, C=C, **GEOM)
    want = jshard.ShardPhi.encode(tiny_problem.phi, op=op,
                                  cell_format=cell_format, R=R, C=C, **GEOM)
    _assert_shards_equal(got, want)


@pytest.mark.parametrize("seed,skewed", RANDOM)
def test_random_and_skewed_encodes_match_reference(seed, skewed):
    """Small random Phis, half with one dominant id per mode (an interior
    cut at offset 0: an empty leading range and, at (4, 2), empty cells),
    both cell formats and ops, through both packages' encode_pair."""
    jphi, tphi = _random_pair(seed, skewed)
    for R, C in ((2, 2), (4, 2), (3, 4)):
        for cell_format in shard.CELL_FORMATS:
            got = shard.encode_pair(tphi, cell_format=cell_format, R=R, C=C,
                                    **GEOM)
            want = jshard.encode_pair(jphi, cell_format=cell_format, R=R,
                                      C=C, **GEOM)
            for g, w in zip(got, want):
                _assert_shards_equal(g, w)


def test_id_cuts_monotone_on_dominant_first_id():
    ids = np.sort(np.asarray([0] * 10 + [1, 2, 3], np.int64))
    got = shard._id_cuts(ids, 4, 4)
    np.testing.assert_array_equal(got, jshard._id_cuts(ids, 4, 4))
    assert (np.diff(got) >= 0).all() and got[0] == 0 and got[-1] == 4


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (4, 2), (3, 4)])
@pytest.mark.parametrize("op", ["dsc", "wc"])
@pytest.mark.parametrize("cell_format", shard.CELL_FORMATS)
def test_decode_roundtrips_the_multiset(cell_format, op, R, C):
    for seed, skewed in RANDOM:
        _, phi = _random_pair(seed, skewed)
        sp = shard.ShardPhi.encode(phi, op=op, cell_format=cell_format,
                                   R=R, C=C, **GEOM)
        back = sp.decode()
        assert sp.n_coeffs == phi.n_coeffs == back.n_coeffs
        for x, y in zip(canonical_triples(phi), canonical_triples(back)):
            np.testing.assert_array_equal(x, y)


def test_shard_is_not_a_leaf_format(tiny_problem):
    assert "shard" not in FORMATS
    with pytest.raises(ValueError, match="cell format"):
        shard.ShardPhi.encode(_port(tiny_problem).phi, cell_format="csr")
    with pytest.raises(ValueError, match="positive"):
        shard.partition_cuts(_port(tiny_problem).phi, 0, 2)


def _inflate_coo(sp, extra: int):
    pad = [(0, 0), (0, 0), (0, extra)]
    return dataclasses.replace(
        sp, arrays={k: np.pad(v, pad) for k, v in sp.arrays.items()})


def _inflate_sell(sp):
    arrays = dict(sp.arrays)
    pad = [(0, 0), (0, 0), (0, sp.row_tile), (0, sp.slot_tile)]
    for k in ("atoms", "others", "values"):
        arrays[k] = np.pad(arrays[k], pad)
    return dataclasses.replace(sp, arrays=arrays)


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (3, 2)])
@pytest.mark.parametrize("cell_format", shard.CELL_FORMATS)
def test_padded_cells_are_inert(cell_format, R, C):
    """More value-0 padding slots in every cell leave both oracles bit for
    bit unchanged."""
    for seed, skewed in RANDOM:
        _, phi = _random_pair(seed, skewed)
        r = np.random.default_rng(seed)
        d = r.normal(size=(phi.n_atoms, 6)).astype(np.float32)
        w = r.uniform(0, 1, phi.n_fibers).astype(np.float32)
        y = r.normal(size=(phi.n_voxels, 6)).astype(np.float32)
        sd, sw = shard.encode_pair(phi, cell_format=cell_format, R=R, C=C,
                                   **GEOM)
        inflate = (_inflate_sell if cell_format == "sell"
                   else lambda s: _inflate_coo(s, 7))
        np.testing.assert_array_equal(shard.dsc_reference(sd, d, w),
                                      shard.dsc_reference(inflate(sd), d, w))
        np.testing.assert_array_equal(shard.wc_reference(sw, d, y),
                                      shard.wc_reference(inflate(sw), d, y))


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (3, 2)])
def test_zero_value_coefficients_are_inert(R, C):
    """Appending value-0 coefficients may move the cuts; in float64 both
    ops stay within 1e-10 of the unaugmented Phi's."""
    for seed, skewed in RANDOM:
        _, phi = _random_pair(seed, skewed)
        r = np.random.default_rng(seed + 100)
        n_zero = int(r.integers(1, 50))

        def ids(n):
            return torch.tensor(r.integers(0, n, n_zero), dtype=torch.int32)

        aug = PhiTensor(
            atoms=torch.cat([phi.atoms, ids(phi.n_atoms)]),
            voxels=torch.cat([phi.voxels, ids(phi.n_voxels)]),
            fibers=torch.cat([phi.fibers, ids(phi.n_fibers)]),
            values=torch.cat([phi.values, torch.zeros(n_zero)]),
            n_atoms=phi.n_atoms, n_voxels=phi.n_voxels,
            n_fibers=phi.n_fibers)
        d = r.normal(size=(phi.n_atoms, 6))
        w = r.uniform(0, 1, phi.n_fibers)
        y = r.normal(size=(phi.n_voxels, 6))
        for cell_format in shard.CELL_FORMATS:
            a = shard.encode_pair(phi, cell_format=cell_format, R=R, C=C,
                                  **GEOM)
            b = shard.encode_pair(aug, cell_format=cell_format, R=R, C=C,
                                  **GEOM)
            np.testing.assert_allclose(shard.dsc_reference(a[0], d, w),
                                       shard.dsc_reference(b[0], d, w),
                                       rtol=1e-10, atol=1e-10)
            np.testing.assert_allclose(shard.wc_reference(a[1], d, y),
                                       shard.wc_reference(b[1], d, y),
                                       rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("R,C", [(2, 2), (3, 2), (4, 2)])
@pytest.mark.parametrize("cell_format", shard.CELL_FORMATS)
def test_references_match_reference_and_dense_oracle(cell_format, R, C,
                                                     tiny_problem,
                                                     tiny_dense, rng):
    """The numpy oracles equal the reference's bit for bit (the same
    numpy code over equal arrays) and agree with the dense oracle within
    rtol 2e-4 / atol 2e-5."""
    p = tiny_problem
    m = np.asarray(tiny_dense, np.float64)
    d = np.asarray(p.dictionary)
    w = rng.uniform(0, 1, p.phi.n_fibers).astype(np.float32)
    y = rng.normal(size=(p.phi.n_voxels, d.shape[1])).astype(np.float32)
    sd, sw = shard.encode_pair(_port(p).phi, cell_format=cell_format, R=R,
                               C=C, **GEOM)
    jd, jw = jshard.encode_pair(p.phi, cell_format=cell_format, R=R, C=C,
                                **GEOM)
    got_y = shard.dsc_reference(sd, d, w)
    got_w = shard.wc_reference(sw, d, y)
    np.testing.assert_array_equal(got_y, jshard.dsc_reference(jd, d, w))
    np.testing.assert_array_equal(got_w, jshard.wc_reference(jw, d, y))
    np.testing.assert_allclose(got_y.astype(np.float64).reshape(-1),
                               m @ w.astype(np.float64),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_w.astype(np.float64),
                               m.T @ y.astype(np.float64).reshape(-1),
                               rtol=2e-4, atol=2e-5)


def test_padding_overhead_and_nbytes(tiny_problem):
    for cell_format in shard.CELL_FORMATS:
        sp = shard.ShardPhi.encode(_port(tiny_problem).phi, op="dsc",
                                   cell_format=cell_format, R=2, C=2,
                                   slot_tile=8)
        assert sp.padding_overhead >= 0.0 and sp.nbytes > 0
        assert sp.arrays["values"].size == pytest.approx(
            (1.0 + sp.padding_overhead) * sp.n_coeffs, rel=1e-6)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_shard_plan_payload_crosses_packages(writer, tmp_path, tiny_problem):
    """A ShardPlan written by either package's PlanCache parses in the
    other's under the same key, cuts and geometry intact."""
    plan = jshard.partition_cuts(tiny_problem.phi, 4, 2)
    key = "f" * 64
    port, ref = PlanCache(str(tmp_path)), JPlanCache(str(tmp_path))
    (port if writer == "port" else ref).put_shard_plan(key, plan)
    for reader in (port, ref):
        got = reader.get_shard_plan(key)
        assert (got.R, got.C) == (4, 2)
        np.testing.assert_array_equal(got.voxel_cuts, plan.voxel_cuts)
        np.testing.assert_array_equal(got.fiber_cuts, plan.fiber_cuts)
    assert port.stats.hits == 1


def test_partition_cuts_through_the_cache(tmp_path, tiny_problem):
    """A warm partition_cuts hits the cache; the key carries the mesh
    shape, the cell format, the backend and the device count."""
    phi = _port(tiny_problem).phi
    cache = PlanCache(str(tmp_path))
    first = shard.partition_cuts(phi, 2, 2, cache=cache)
    again = shard.partition_cuts(phi, 2, 2, cache=cache)
    assert (cache.stats.misses, cache.stats.hits) == (1, 1)
    np.testing.assert_array_equal(first.voxel_cuts, again.voxel_cuts)
    arrays = [t.numpy() for t in (phi.atoms, phi.voxels, phi.fibers)]
    base = dict(sizes=(phi.n_atoms, phi.n_voxels, phi.n_fibers), R=2, C=2,
                cell_format="coo", backend="cpu", n_devices=1)
    keys = {shard_plan_key(*arrays, **dict(base, **change))
            for change in ({}, dict(R=4), dict(cell_format="sell"),
                           dict(backend="cuda"), dict(n_devices=8))}
    assert len(keys) == 5
