"""Port vs reference: the COO kernels B1 (DSC) and B2 (WC).

On the CPU the wrappers run their kernels' plain PyTorch versions; these
tests hold them, and ``ops.make_dsc`` / ``make_wc`` built over them, against
the reference's ``kernel`` executor in Pallas interpret mode (as
tests/test_kernels.py runs it) and against the per-tile oracles of
``kernels/ref.py``.  The CUDA kernels themselves are held against the plain
versions by ``chip_smoke.py`` and by the ``gpu``-marked test below on a card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.inspector import plan_tiles as jplan_tiles
from repro.core.restructure import sort_by_host as jsort_by_host
from repro.core.std import PhiTensor as JPhi
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.bridge import to_numpy
from repro_torch.core.inspector import plan_tiles
from repro_torch.core.restructure import sort_by_host
from repro_torch.core.std import PhiTensor
from repro_torch.kernels import _build, dsc, ops, ref, wc

FP32 = dict(rtol=2e-4, atol=2e-5)
#: bf16-storage contract (repro/tune/plan.py:25-26)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(nc, na, nv, nf, seed, skip_rows=()):
    """tests/test_kernels.py:_problem, for both packages; ids in
    ``skip_rows`` get no coefficient (row blocks no tile visits)."""
    r = np.random.default_rng(seed)
    a = r.integers(0, na, nc)
    v = r.choice(np.setdiff1d(np.arange(nv), skip_rows), nc)
    f = r.choice(np.setdiff1d(np.arange(nf), skip_rows), nc)
    vals = r.normal(size=nc).astype(np.float32)
    j = JPhi(atoms=jnp.asarray(a, jnp.int32), voxels=jnp.asarray(v, jnp.int32),
             fibers=jnp.asarray(f, jnp.int32), values=jnp.asarray(vals),
             n_atoms=na, n_voxels=nv, n_fibers=nf)
    t = PhiTensor(atoms=torch.tensor(a, dtype=torch.int32),
                  voxels=torch.tensor(v, dtype=torch.int32),
                  fibers=torch.tensor(f, dtype=torch.int32),
                  values=torch.tensor(vals), n_atoms=na, n_voxels=nv,
                  n_fibers=nf)
    return j, t


def _dictionary(na, n_theta, seed=0):
    return np.random.default_rng(seed).normal(size=(na, n_theta)).astype(
        np.float32)


SHAPES = [(50, 40, 30, 16, 4), (513, 100, 64, 64, 8), (7, 300, 200, 32, 16)]


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("nc,nv,nf,c_tile,row_tile", SHAPES)
def test_make_dsc_matches_reference_kernel(nc, nv, nf, c_tile, row_tile,
                                           compute_dtype):
    jphi, tphi = _problem(nc, 12, nv, nf, seed=nc)
    d = _dictionary(12, 16)
    w = np.random.default_rng(1).uniform(size=nf).astype(np.float32)
    jv, _ = jsort_by_host(jphi, "voxel")
    tv, _ = sort_by_host(tphi, "voxel")
    jplan = jplan_tiles(np.asarray(jv.voxels), nv, c_tile=c_tile,
                        row_tile=row_tile)
    plan = plan_tiles(to_numpy(tv.voxels), nv, c_tile=c_tile,
                      row_tile=row_tile)
    want = jops.make_dsc(jv, jnp.asarray(d), jplan, interpret=True,
                         compute_dtype=compute_dtype)(jnp.asarray(w))
    got = ops.make_dsc(tv, torch.tensor(d), plan,
                       compute_dtype=compute_dtype)(torch.tensor(w))
    assert got.shape == (nv, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **FP32)


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("nc,nv,nf,c_tile,row_tile", SHAPES[:2])
def test_make_wc_matches_reference_kernel(nc, nv, nf, c_tile, row_tile,
                                          compute_dtype):
    jphi, tphi = _problem(nc, 12, nv, nf, seed=7 * nc)
    d = _dictionary(12, 16)
    y = np.random.default_rng(2).normal(size=(nv, 16)).astype(np.float32)
    jf, _ = jsort_by_host(jphi, "fiber")
    tf, _ = sort_by_host(tphi, "fiber")
    jplan = jplan_tiles(np.asarray(jf.fibers), nf, c_tile=c_tile,
                        row_tile=row_tile)
    plan = plan_tiles(to_numpy(tf.fibers), nf, c_tile=c_tile,
                      row_tile=row_tile)
    want = jops.make_wc(jf, jnp.asarray(d), jplan, interpret=True,
                        compute_dtype=compute_dtype)(jnp.asarray(y))
    got = ops.make_wc(tf, torch.tensor(d), plan,
                      compute_dtype=compute_dtype)(torch.tensor(y))
    assert got.shape == (nf,) and got.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **FP32)


def _operands(tphi, op, c_tile, row_tile, compute_dtype="fp32"):
    dim, n_rows, others = (("voxel", tphi.n_voxels, "fibers") if op == "dsc"
                           else ("fiber", tphi.n_fibers, "voxels"))
    ts, _ = sort_by_host(tphi, dim)
    plan = plan_tiles(to_numpy(getattr(ts, dim + "s")), n_rows,
                      c_tile=c_tile, row_tile=row_tile)
    return ops.coo_tiles(ts, plan, getattr(ts, others), n_rows,
                         compute_dtype=compute_dtype), plan


def _run(op, t, d, x, plain=False):
    fn = {("dsc", False): dsc.dsc_coo, ("dsc", True): dsc.dsc_coo_plain,
          ("wc", False): wc.wc_coo, ("wc", True): wc.wc_coo_plain}[op, plain]
    return fn(t.tile_ptr, t.tile_len, t.atoms_p, t.others_p, t.values_p,
              t.local_row_p, d, x, row_tile=t.row_tile)


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("nc,nv,nf,c_tile,row_tile", SHAPES)
def test_plain_versions_match_tile_oracles(nc, nv, nf, c_tile, row_tile,
                                           compute_dtype):
    """Plain B1/B2 against kernels/ref.py on the same padded tiles; in fp32
    the port's oracles also match the reference's."""
    jphi, tphi = _problem(nc, 12, nv, nf, seed=3 * nc)
    d32 = torch.tensor(_dictionary(12, 16))
    d = ops.storage_cast(d32, compute_dtype)
    r = np.random.default_rng(4)
    w = torch.tensor(r.uniform(size=nf).astype(np.float32))
    y = torch.tensor(r.normal(size=(nv, 16)).astype(np.float32))

    t, _ = _operands(tphi, "dsc", c_tile, row_tile, compute_dtype)
    row_block = torch.repeat_interleave(
        torch.arange(t.n_row_blocks), t.tile_ptr.diff().long())
    scaled_p = w[t.others_p] * t.values_p.float()
    want = ref.dsc_ref(row_block, t.atoms_p, scaled_p, t.local_row_p, d,
                       row_tile=row_tile, n_row_blocks=t.n_row_blocks)
    got = _run("dsc", t, d, w)
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=1e-6,
                               atol=1e-6)
    if compute_dtype == "fp32":
        jwant = jref.dsc_ref(jnp.asarray(to_numpy(row_block)),
                             jnp.asarray(to_numpy(t.atoms_p)),
                             jnp.asarray(to_numpy(scaled_p)),
                             jnp.asarray(to_numpy(t.local_row_p)),
                             jnp.asarray(to_numpy(d)), row_tile=row_tile,
                             n_row_blocks=t.n_row_blocks)
        np.testing.assert_allclose(to_numpy(want), np.asarray(jwant), **FP32)

    t, _ = _operands(tphi, "wc", c_tile, row_tile, compute_dtype)
    row_block = torch.repeat_interleave(
        torch.arange(t.n_row_blocks), t.tile_ptr.diff().long())
    yg_p = y[t.others_p]
    want = ref.wc_ref(row_block, t.atoms_p, yg_p, t.values_p, t.local_row_p,
                      d, fib_tile=row_tile, n_fib_blocks=t.n_row_blocks)
    got = _run("wc", t, d, y)
    np.testing.assert_allclose(to_numpy(got), to_numpy(want).reshape(-1),
                               rtol=1e-6, atol=1e-6)
    if compute_dtype == "fp32":
        jwant = jref.wc_ref(jnp.asarray(to_numpy(row_block)),
                            jnp.asarray(to_numpy(t.atoms_p)),
                            jnp.asarray(to_numpy(yg_p)),
                            jnp.asarray(to_numpy(t.values_p)),
                            jnp.asarray(to_numpy(t.local_row_p)),
                            jnp.asarray(to_numpy(d)), fib_tile=row_tile,
                            n_fib_blocks=t.n_row_blocks)
        np.testing.assert_allclose(to_numpy(want), np.asarray(jwant), **FP32)


@pytest.mark.parametrize("op", ["dsc", "wc"])
def test_unvisited_row_block_is_exactly_zero(op):
    """Row blocks 2 and 5 get no coefficient: their rows come out exactly
    0 (the reference needs its _visited_mask for this; the port's kernels
    write every row)."""
    skip = np.r_[16:24, 40:48]
    _, tphi = _problem(300, 12, 64, 64, seed=9, skip_rows=skip)
    t, plan = _operands(tphi, op, 32, 8)
    assert 2 not in plan.row_block and 5 not in plan.row_block
    assert t.tile_ptr[2] == t.tile_ptr[3] and t.tile_ptr[5] == t.tile_ptr[6]
    d = torch.tensor(_dictionary(12, 16))
    x = (torch.ones(64) if op == "dsc" else torch.ones(64, 16))
    out = _run(op, t, d, x)
    assert torch.count_nonzero(out[skip]) == 0
    assert torch.count_nonzero(out) > 0


def test_coo_tiles_layout_and_padding():
    _, tphi = _problem(700, 12, 20, 30, seed=5)
    t, plan = _operands(tphi, "dsc", 64, 8)
    assert t.tile_ptr.dtype == torch.int32 and t.tile_ptr[-1] == plan.n_tiles
    for b in range(t.n_row_blocks):
        lo, hi = int(t.tile_ptr[b]), int(t.tile_ptr[b + 1])
        assert np.all(plan.row_block[lo:hi] == b)
    real = plan.sel.reshape(plan.n_tiles, -1) < plan.n_coeffs
    np.testing.assert_array_equal(to_numpy(t.tile_len), real.sum(1))
    assert int(t.tile_len.sum()) == tphi.n_coeffs
    assert torch.count_nonzero(t.values_p[torch.tensor(~real)]) == 0
    assert max(np.diff(to_numpy(t.tile_ptr))) > 1      # a run over tiles
    other, _ = _problem(10, 12, 20, 30, seed=6)
    with pytest.raises(ValueError, match="coefficients"):
        ops.coo_tiles(other, plan, other.fibers, 20)


@pytest.mark.parametrize("op", ["dsc", "wc"])
@pytest.mark.parametrize("nc,c_tile,row_tile", [
    (900, 8, 4), (900, 32, 8), (2500, 64, 16), (2500, 256, 8), (0, 32, 8)])
def test_coo_tiles_give_what_the_kernels_walk(op, nc, c_tile, row_tile):
    """What B1 and B2 rely on (csrc/common.cuh:TileWalk): every tile's real
    slots are a prefix of it, tile_ptr covers the tiles in order, each real
    slot's row block * row_tile + local_row is its sorted id, and local_row
    lies in [0, row_tile) and never decreases within a row block, across
    its tiles too.  The plans have empty row blocks and a row block of
    several tiles (a hot id)."""
    r = np.random.default_rng(nc + c_tile + row_tile)
    nv = nf = 160
    skip = np.r_[16:32, 96:100]
    ids = lambda n: np.r_[r.choice(np.setdiff1d(np.arange(n), skip), nc),
                          np.full(nc // 10, 5)]
    v, f = ids(nv), ids(nf)
    n = v.size
    tphi = PhiTensor(atoms=torch.tensor(r.integers(0, 12, n),
                                        dtype=torch.int32),
                     voxels=torch.tensor(v, dtype=torch.int32),
                     fibers=torch.tensor(f, dtype=torch.int32),
                     values=torch.tensor(r.normal(size=n), dtype=torch.float32),
                     n_atoms=12, n_voxels=nv, n_fibers=nf)
    t, plan = _operands(tphi, op, c_tile, row_tile)
    sorted_ids = np.sort(v if op == "dsc" else f)
    tile_ptr, tile_len = to_numpy(t.tile_ptr), to_numpy(t.tile_len)
    local_row = to_numpy(t.local_row_p)
    sel = plan.sel.reshape(plan.n_tiles, c_tile)
    # tile_ptr covers the tiles, in order, each row block's own
    assert t.n_row_blocks == -(-nv // row_tile)
    assert tile_ptr[0] == 0 and tile_ptr[-1] == plan.n_tiles
    assert np.all(np.diff(tile_ptr) >= 0)
    for b in range(t.n_row_blocks):
        assert np.all(plan.row_block[tile_ptr[b]:tile_ptr[b + 1]] == b)
    # a real prefix per tile: real slots first, padding (value 0) after
    real = np.arange(c_tile)[None, :] < tile_len[:, None]
    np.testing.assert_array_equal(sel < n, real)
    assert np.all(to_numpy(t.values_p)[~real] == 0)
    assert int(tile_len.sum()) == n
    if n:
        assert tile_len.min() >= 1 and tile_len.max() <= c_tile
    # local_row in [0, row_tile), the sorted id, nondecreasing by row block
    assert np.all((local_row >= 0) & (local_row < row_tile))
    rows = (plan.row_block[:, None] * row_tile + local_row)[real]
    np.testing.assert_array_equal(rows, sorted_ids)
    spans = np.diff(tile_ptr)
    for b in range(t.n_row_blocks):
        walked = local_row[tile_ptr[b]:tile_ptr[b + 1]][
            real[tile_ptr[b]:tile_ptr[b + 1]]]
        assert np.all(np.diff(walked) >= 0)
    if n:   # the plan has the edges the kernels handle
        assert np.any(spans == 0) and spans.max() >= 2


def test_wrappers_dispatch_by_device_and_check_operands():
    _, tphi = _problem(100, 12, 40, 30, seed=8)
    t, _ = _operands(tphi, "dsc", 32, 8)
    d = torch.tensor(_dictionary(12, 16))
    w = torch.rand(30)
    before = dict(_build.LAUNCHES)
    assert torch.equal(_run("dsc", t, d, w), _run("dsc", t, d, w, plain=True))
    assert dict(_build.LAUNCHES) == before           # CPU: no kernel launch
    with pytest.raises(TypeError, match="w has dtype"):
        _run("dsc", t, d, w.double())
    with pytest.raises(TypeError, match="values_p"):
        _run("dsc", t, d.to(torch.bfloat16), w)
    with pytest.raises(ValueError, match="contiguous"):
        dsc.dsc_coo(t.tile_ptr, t.tile_len, t.atoms_p.t().contiguous().t(),
                    t.others_p, t.values_p, t.local_row_p, d, w,
                    row_tile=t.row_tile)
    meta = [x.to("meta") for x in (t.tile_ptr, t.tile_len, t.atoms_p,
                                   t.others_p, t.values_p, t.local_row_p, d, w)]
    out = dsc.dsc_coo(*meta, row_tile=t.row_tile)     # a trace's op
    assert out.is_meta and out.shape == _run("dsc", t, d, w).shape
    assert dict(_build.LAUNCHES) == before
    with pytest.raises(ValueError, match="is on"):
        dsc.dsc_coo(*meta[:-1], w, row_tile=t.row_tile)


def test_build_names_sources_and_refuses_without_toolkit(monkeypatch,
                                                         tmp_path):
    """Kernel sources are found in csrc/, libraries are named by a digest of
    their sources, and with no CUDA toolkit the build raises."""
    import torch.utils.cpp_extension as cpp
    assert _build.kernel_names() == ("dsc", "dsc_fcoo", "dsc_sell", "moe_gmm",
                                     "wc", "wc_fcoo", "wc_sell")
    p_dsc, p_wc = _build.library_path("dsc"), _build.library_path("wc")
    assert p_dsc != p_wc and p_dsc == _build.library_path("dsc")
    assert p_dsc.parent == _build.BUILD_DIR
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="CUDA toolkit"):
        _build.build(["dsc"])


def test_load_builds_a_library_once_across_threads(monkeypatch):
    """Two threads asking for one kernel library at once: the compiler
    (stubbed) runs once and both get the same loaded library."""
    import ctypes
    import threading
    import time
    builds, loads = [], []

    def slow_build(names):
        builds.append(tuple(names))
        time.sleep(0.2)                  # both threads arrive meanwhile
        return {n: 0.0 for n in names}

    class FakeLib:
        def __init__(self, path):
            loads.append(path)
            self.entry = type("Fn", (), {})()

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_build, "_LIBS", {})
    got = [None, None]
    start = threading.Barrier(2)

    def ask(i):
        start.wait(timeout=10)
        got[i] = _build.load("dsc", {"entry": [ctypes.c_int]})

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert builds == [("dsc",)] and len(loads) == 1
    assert got[0] is got[1] is not None
    assert got[0].entry.restype is ctypes.c_int


@pytest.mark.gpu
@pytest.mark.parametrize("n_atoms,row_tile", [(40, 8), (40, 16), (8192, 4)])
@pytest.mark.parametrize("n_theta", [16, 64, 96, 128, 160])
@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
def test_cuda_kernels_match_plain_versions_on_card(compute_dtype, n_theta,
                                                   n_atoms, row_tile):
    """B1 and B2 at every width they dispatch on: Ntheta 16, 64 and 128 take
    B1's 1, 2 and 4 columns per lane and B2's float4 paths of 1, 2 and 4
    vectors, 160 B1's two column passes and B2's scalar path; 40 atoms
    stage D in shared memory, 8192 atoms do not fit there.  A second launch
    is bit-identical and the rows no coefficient reaches are exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    skip = np.r_[8:24]
    _, tphi = _problem(3000, n_atoms, 500, 300, seed=10, skip_rows=skip)
    tphi = tphi.to("cuda")
    d = ops.storage_cast(torch.tensor(_dictionary(n_atoms, n_theta)).cuda(),
                         compute_dtype)
    tol = FP32 if compute_dtype == "fp32" else BF16
    w = torch.rand(300, device="cuda")
    y = torch.randn(500, n_theta, device="cuda")
    for op, x in (("dsc", w), ("wc", y)):
        t, _ = _operands(tphi, op, 64, row_tile, compute_dtype)
        n = _build.launches(f"{op}_coo")
        got = _run(op, t, d, x)
        torch.cuda.synchronize()
        assert _build.launches(f"{op}_coo") == n + 1
        torch.testing.assert_close(got, _run(op, t, d, x, plain=True), **tol)
        assert torch.equal(got, _run(op, t, d, x))
        assert torch.count_nonzero(got[skip]) == 0
