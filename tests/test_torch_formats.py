"""Port vs reference: the Phi formats, their selection and cached plans.

The encoders are host numpy in both packages, so the port's SELL, F-COO,
ALTO and COO encodings and ``phi_stats`` must equal the reference's array
for array on the same input; decode must give back the input's exact
coefficient multiset.  Selection must reach the reference's
``FormatPlan`` (format and reason) on the rungs whose outcome does not
depend on timing; the measured rung only has to pick a candidate.  Warm
rebuilds read the cached FormatPlan and SpmvPlans.

Inputs are made with numpy from a seed and cross between the packages as
numpy arrays.  The reference gives an empty F-COO Phi a padding overhead
of -1.0 (ROADMAP §C); the port gives 0.0, so that field is not compared on
empty input.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inspector as jinspector
from repro.core.life import LifeConfig as JConfig
from repro.core.life import LifeEngine as JEngine
from repro.core.plan_cache import PlanCache as JPlanCache
from repro.core.std import PhiTensor as JPhi
from repro.formats import alto as jalto
from repro.formats import coo as jcoo
from repro.formats import fcoo as jfcoo
from repro.formats import select as jselect
from repro.formats import sell as jsell
from repro_torch.bridge import from_reference, to_numpy
from repro_torch.core import inspector
from repro_torch.core.life import LifeConfig, LifeEngine
from repro_torch.core.plan_cache import PlanCache, format_plan_key
from repro_torch.core.std import PhiTensor
from repro_torch.formats import (AltoPhi, CooPhi, FcooPhi, FormatPlan,
                                 SellPhi, canonical_triples, format_names,
                                 get_format)
from repro_torch.formats import fcoo as fcoo_mod
from repro_torch.formats import select as fsel
from repro_torch.formats import sell as sell_mod
from repro_torch.tune import search


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(nc, na, nv, nf, seed, hot=0):
    """Random Phi arrays plus ``hot`` duplicates on voxel 2 / fiber 1 (a
    long run in both ops)."""
    r = np.random.default_rng(seed)
    a = np.concatenate([r.integers(0, na, nc), r.integers(0, na, hot)])
    v = np.concatenate([r.integers(0, nv, nc), np.full(hot, 2)])
    f = np.concatenate([r.integers(0, nf, nc), np.full(hot, 1)])
    vals = r.normal(size=nc + hot).astype(np.float32)
    return a, v, f, vals, (na, nv, nf)


def _both(a, v, f, vals, sizes):
    na, nv, nf = sizes
    j = JPhi(atoms=jnp.asarray(a, jnp.int32), voxels=jnp.asarray(v, jnp.int32),
             fibers=jnp.asarray(f, jnp.int32), values=jnp.asarray(vals),
             n_atoms=na, n_voxels=nv, n_fibers=nf)
    t = PhiTensor(atoms=torch.tensor(a, dtype=torch.int32),
                  voxels=torch.tensor(v, dtype=torch.int32),
                  fibers=torch.tensor(f, dtype=torch.int32),
                  values=torch.tensor(vals), n_atoms=na, n_voxels=nv,
                  n_fibers=nf)
    return j, t


def _uniform():
    """Every voxel and every fiber holds exactly 32 coefficients (SELL pads
    nothing): tests/test_formats.py:_uniform_phi's shape."""
    nv = nf = 64
    r = np.random.default_rng(3)
    v = np.repeat(np.arange(nv), 32)
    f = np.tile(np.arange(nf), 32)
    return (r.integers(0, 8, v.size), v, f,
            r.normal(size=v.size).astype(np.float32), (8, nv, nf))


def _skewed():
    """One voxel and one fiber hold most coefficients (SELL overhead far
    above sell_reject)."""
    return _arrays(200, 8, 256, 64, seed=4, hot=600)


CASES = {
    "random": lambda: _arrays(900, 12, 150, 40, seed=1),
    "long-runs": lambda: _arrays(500, 6, 60, 30, seed=2, hot=300),
    "one": lambda: _arrays(1, 3, 5, 4, seed=3),
    "empty": lambda: _arrays(0, 3, 5, 4, seed=4),
}


def _port(p):
    ph = p.phi
    return from_reference(ph.atoms, ph.voxels, ph.fibers, ph.values,
                          ph.n_atoms, ph.n_voxels, ph.n_fibers, p.dictionary,
                          p.b, p.w_true, device="cpu")


# ----------------------------------------------------------------------------
# encoders, array for array
# ----------------------------------------------------------------------------

def test_registry_lists_formats():
    assert format_names() == ("alto", "coo", "fcoo", "sell")
    assert get_format("sell") is SellPhi
    with pytest.raises(ValueError, match="must be one of"):
        get_format("csr")


@pytest.mark.parametrize("case", CASES)
def test_phi_stats_match_reference(case):
    j, t = _both(*CASES[case]())
    for geom in (dict(), dict(row_tile=4, slot_tile=16)):
        assert inspector.phi_stats(t, **geom) == jinspector.phi_stats(j, **geom)
    assert inspector.sell_geometry(33, 17, row_tile=8, slot_tile=32) == \
        jinspector.sell_geometry(33, 17, row_tile=8, slot_tile=32)


@pytest.mark.parametrize("geom", [dict(), dict(row_tile=4, slot_tile=8)])
@pytest.mark.parametrize("op", ["dsc", "wc"])
@pytest.mark.parametrize("case", CASES)
def test_sell_encode_matches_reference(case, op, geom):
    j, t = _both(*CASES[case]())
    want = jsell.SellPhi.encode(j, op=op, **geom)
    got = SellPhi.encode(t, op=op, **geom)
    for name in ("atoms", "others", "values", "row_nnz"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for name in ("row_tile", "slot_tile", "width", "n_rows", "n_coeffs",
                 "nbytes", "padding_overhead", "n_row_blocks", "n_chunks"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_array_equal(got.slice_widths, want.slice_widths)


@pytest.mark.parametrize("geom", [dict(), dict(c_tile=32, seg_tile=4)])
@pytest.mark.parametrize("case", CASES)
def test_fcoo_encode_matches_reference(case, geom):
    j, t = _both(*CASES[case]())
    want = jfcoo.FcooPhi.encode(j, **geom)
    got = FcooPhi.encode(t, **geom)
    for name in ("atoms", "voxels", "fibers", "values", "wc_perm",
                 "dsc_ranks", "wc_ranks", "seg_rows_dsc", "seg_rows_wc"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    for name in ("c_tile", "seg_tile", "n_coeffs", "n_chunks", "k_dsc",
                 "k_wc", "nbytes"):
        assert getattr(got, name) == getattr(want, name), name
    if case == "empty":                 # the reference says -1.0 (ROADMAP §C)
        assert got.padding_overhead == 0.0
    else:
        assert got.padding_overhead == want.padding_overhead


@pytest.mark.parametrize("case", CASES)
def test_alto_and_coo_encodes_match_reference(case):
    j, t = _both(*CASES[case]())
    got, want = AltoPhi.encode(t), jalto.AltoPhi.encode(j)
    np.testing.assert_array_equal(got.lin, want.lin)
    np.testing.assert_array_equal(got.values, want.values)
    (gs, gorder), (ws, worder) = got.sort(), want.sort()
    np.testing.assert_array_equal(gorder, worder)
    np.testing.assert_array_equal(gs.lin, ws.lin)
    keep = np.arange(got.n_coeffs) % 3 > 0
    np.testing.assert_array_equal(got.compact(keep).lin,
                                  want.compact(keep).lin)
    assert got.nbytes == want.nbytes and got.padding_overhead == 0.0
    np.testing.assert_array_equal(got.fibers_of(), want.fibers_of())
    for op in ("dsc", "wc"):
        np.testing.assert_array_equal(CooPhi.encode(t, op=op).order,
                                      jcoo.CooPhi.encode(j, op=op).order)


@pytest.mark.parametrize("fmt,op", [("coo", "dsc"), ("coo", "wc"),
                                    ("sell", "dsc"), ("sell", "wc"),
                                    ("fcoo", "dsc"), ("alto", "dsc")])
@pytest.mark.parametrize("case", CASES)
def test_decode_round_trips_the_multiset(case, fmt, op):
    _, t = _both(*CASES[case]())
    back = get_format(fmt).encode(t, op=op).decode()
    assert isinstance(back, PhiTensor) and back.device == t.device
    assert (back.n_atoms, back.n_voxels, back.n_fibers) == (
        t.n_atoms, t.n_voxels, t.n_fibers)
    for x, y in zip(canonical_triples(back), canonical_triples(t)):
        np.testing.assert_array_equal(x, y)


def test_coo_decode_restores_input_order():
    _, t = _both(*CASES["long-runs"]())
    back = CooPhi.encode(t, op="wc").decode()
    for name in ("atoms", "voxels", "fibers", "values"):
        assert torch.equal(getattr(back, name), getattr(t, name))


def test_chunk_segment_map_matches_reference():
    ids = np.sort(np.random.default_rng(0).integers(0, 40, 256))
    for c_tile, seg_tile in ((32, 4), (64, 16), (256, 8)):
        got = fcoo_mod.chunk_segment_map(ids, c_tile, seg_tile, 40)
        want = jfcoo.chunk_segment_map(ids, c_tile, seg_tile, 40)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="multiple"):
        fcoo_mod.chunk_segment_map(ids[:10], 32, 4, 40)


@pytest.mark.parametrize("case", ["random", "long-runs", "empty"])
def test_layout_references_match_reference(case, rng):
    """The torch oracles of the SELL and F-COO layouts against the
    reference's jnp ones (fp32)."""
    a, v, f, vals, (na, nv, nf) = CASES[case]()
    j, t = _both(a, v, f, vals, (na, nv, nf))
    d = rng.normal(size=(na, 8)).astype(np.float32)
    w = rng.uniform(size=nf).astype(np.float32)
    y = rng.normal(size=(nv, 8)).astype(np.float32)
    tol = dict(rtol=2e-4, atol=2e-5)
    for port, ref, x in ((sell_mod.dsc_reference, jsell.dsc_reference, w),
                         (fcoo_mod.dsc_reference, jfcoo.dsc_reference, w),
                         (sell_mod.wc_reference, jsell.wc_reference, y),
                         (fcoo_mod.wc_reference, jfcoo.wc_reference, y)):
        op = "dsc" if x is w else "wc"
        if port.__module__.endswith("sell"):
            enc_t, enc_j = SellPhi.encode(t, op=op), jsell.SellPhi.encode(j, op=op)
        else:
            enc_t, enc_j = FcooPhi.encode(t), jfcoo.FcooPhi.encode(j)
        got = port(enc_t, torch.tensor(d), torch.tensor(x))
        want = ref(enc_j, jnp.asarray(d), jnp.asarray(x))
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), **tol)


# ----------------------------------------------------------------------------
# format selection
# ----------------------------------------------------------------------------

def _choose_both(arrays, **kw):
    j, t = _both(*arrays)
    d = np.random.default_rng(5).normal(size=(t.n_atoms, 8)).astype(
        np.float32)
    return (fsel.choose_format(t, torch.tensor(d), **kw),
            jselect.choose_format(j, jnp.asarray(d), **kw))


def test_selection_heuristic_accept_matches_reference():
    got, want = _choose_both(_uniform())
    assert (got.format, got.reason) == (want.format, want.reason) == (
        "sell", "heuristic")
    assert got.stats == want.stats and got.params == want.params


def test_selection_heuristic_reject_matches_reference():
    got, want = _choose_both(_skewed(), allowed=("coo", "sell"))
    assert (got.format, got.reason) == (want.format, want.reason) == (
        "coo", "heuristic")
    assert got.stats["dsc.sell_overhead"] >= fsel.DEFAULT_SELL_REJECT
    got, want = _choose_both(_skewed(), allowed=("sell",))
    assert (got.format, got.reason) == (want.format, want.reason) == (
        "sell", "heuristic")
    with pytest.raises(ValueError, match="at least one"):
        _choose_both(_skewed(), allowed=())


def test_selection_measured_rung_picks_a_candidate():
    """SELL is struck by the skew; coo, alto and fcoo are timed through the
    shared measurement loop (three candidates, one time_call each)."""
    before = search.measurement_count()
    got, want = _choose_both(_skewed())
    assert got.reason == want.reason == "autotune"
    assert got.format in ("coo", "alto", "fcoo")
    assert search.measurement_count() - before == 3


def _spy_coo_dsc(monkeypatch):
    """Count the coo candidate's DSC builds and calls on B1's path
    (``kernels/ops.py:make_dsc``) and on ``opt``'s (``core/spmv.py:dsc``)."""
    from repro_torch.core import spmv
    from repro_torch.kernels import ops as kops
    seen = {"make_dsc": 0, "make_dsc.calls": 0, "spmv.dsc": 0}
    make_dsc, dsc = kops.make_dsc, spmv.dsc

    def spy_make_dsc(*a, **k):
        seen["make_dsc"] += 1
        matvec = make_dsc(*a, **k)

        def counted(w):
            seen["make_dsc.calls"] += 1
            return matvec(w)
        return counted

    def spy_dsc(*a, **k):
        seen["spmv.dsc"] += 1
        return dsc(*a, **k)

    monkeypatch.setattr(kops, "make_dsc", spy_make_dsc)
    monkeypatch.setattr(spmv, "dsc", spy_dsc)
    return seen


@pytest.mark.parametrize("executor", ["kernel", "opt"])
def test_measured_rung_times_coo_on_its_executor(executor, monkeypatch):
    """The coo candidate is timed on what ``executor_for("coo", config)``
    runs: B1 over the inspector's tile plan (``make_dsc``) under
    ``executor="kernel"``, never ``opt``'s ``spmv.dsc``; ``spmv.dsc`` under
    ``executor="opt"``.  SELL is struck, so coo, alto and fcoo are timed."""
    from types import SimpleNamespace
    _, t = _both(*_skewed())
    d = torch.tensor(np.random.default_rng(5).normal(
        size=(t.n_atoms, 8)).astype(np.float32))
    seen = _spy_coo_dsc(monkeypatch)
    before = search.measurement_count()
    plan = fsel.resolve_format(
        t, SimpleNamespace(dictionary=d),
        LifeConfig(executor=executor, format="auto", c_tile=64,
                   plan_cache_dir=""))
    assert plan.reason == "autotune"
    assert search.measurement_count() - before == 3
    if executor == "kernel":
        assert seen["make_dsc"] == 1 and seen["make_dsc.calls"] >= 2
        assert seen["spmv.dsc"] == 0
    else:
        assert seen["make_dsc"] == 0 and seen["spmv.dsc"] >= 2


def test_cohort_selection_still_times_opt_dsc(monkeypatch, tiny_cohort):
    """The cohort engine (executor="opt", coo vs alto) times ``opt``'s
    ``spmv.dsc`` for coo, as before the measured rung followed the
    executor, and never builds B1's operands."""
    from repro_torch.core.batched import BatchedLifeEngine
    cohort = [_port(p) for p in tiny_cohort]
    seen = _spy_coo_dsc(monkeypatch)
    eng = BatchedLifeEngine(cohort, LifeConfig(executor="opt", format="auto",
                                               plan_cache_dir=""),
                            device="cpu")
    assert eng.format_plan.reason == "autotune"
    assert eng.format_plan.format in ("coo", "alto")
    assert seen["make_dsc"] == 0 and seen["spmv.dsc"] >= 2


def test_format_plan_key_carries_the_coo_executor(tmp_path, tiny_problem):
    """A FormatPlan chosen with coo timed on B1 is not replayed for
    ``opt`` (and the other way round): the key carries the executor."""
    tp = _port(tiny_problem)
    common = dict(sizes=(tp.phi.n_atoms, tp.phi.n_voxels, tp.phi.n_fibers),
                  row_tile=8, slot_tile=32, allowed=fsel.DEFAULT_CANDIDATES,
                  backend="cpu")
    ids = (tp.phi.atoms.numpy(), tp.phi.voxels.numpy(),
           tp.phi.fibers.numpy())
    keys = {ex: format_plan_key(*ids, coo_executor=ex, **common)
            for ex in ("opt", "kernel", "naive")}
    assert len(set(keys.values())) == 3
    cfg = LifeConfig(format="auto", c_tile=64, plan_cache_dir=str(tmp_path))
    first = LifeEngine(tp, dataclasses.replace(cfg, executor="kernel"),
                       device="cpu")
    assert first.cache_stats.misses >= 1
    other = LifeEngine(tp, dataclasses.replace(cfg, executor="opt"),
                       device="cpu")
    assert other.cache_stats.hits == 0
    again = LifeEngine(tp, dataclasses.replace(cfg, executor="kernel"),
                       device="cpu")
    assert again.cache_stats.misses == 0
    assert dataclasses.asdict(again.format_plan) == \
        dataclasses.asdict(first.format_plan)


@pytest.mark.parametrize("fmt", ["coo", "sell", "alto", "fcoo"])
def test_selection_explicit_format_and_executor_match_reference(
        fmt, tiny_problem):
    p = tiny_problem
    cfg = LifeConfig(format=fmt, row_tile=4, slot_tile=16)
    jcfg = JConfig(format=fmt, row_tile=4, slot_tile=16)
    got = fsel.resolve_format(_port(p).phi, _port(p), cfg)
    want = jselect.resolve_format(p.phi, p, jcfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for executor in ("opt", "kernel", "kernel-sell", "alto"):
        assert fsel.executor_for(fmt, dataclasses.replace(
            cfg, executor=executor)) == jselect.executor_for(
                fmt, dataclasses.replace(jcfg, executor=executor))
    with pytest.raises(ValueError, match="format must be one of"):
        fsel.executor_for("csr", cfg)
    # under a multi-cell mesh: the explicit format stands, and the mesh
    # rule maps it to its mesh executor where it has one
    mcfg = dataclasses.replace(cfg, shard_cols=2)
    mjcfg = dataclasses.replace(jcfg, shard_cols=2)
    got = fsel.resolve_format(_port(p).phi, _port(p), mcfg)
    want = jselect.resolve_format(p.phi, p, mjcfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for executor in ("opt", "kernel", "kernel-sell", "alto", "shard-sell"):
        assert fsel.executor_for(fmt, dataclasses.replace(
            mcfg, executor=executor)) == jselect.executor_for(
                fmt, dataclasses.replace(mjcfg, executor=executor))


def test_engine_auto_format_matches_reference_reason(tiny_problem):
    """format="auto" through both engines (the reference without a
    predictor): the same rung decides; a measured choice is a candidate."""
    p = tiny_problem
    eng = LifeEngine(_port(p), LifeConfig(format="auto", plan_cache_dir=""),
                     device="cpu")
    jeng = JEngine(p, JConfig(format="auto", predict="off",
                              plan_cache_dir=""))
    got, want = eng.format_plan, jeng.format_plan
    assert got.reason == want.reason
    assert got.stats == want.stats
    if got.reason == "heuristic":
        assert got.format == want.format
    assert got.format in fsel.DEFAULT_CANDIDATES
    assert eng.executor.name == fsel.executor_for(got.format, eng.config)


# ----------------------------------------------------------------------------
# cached plans
# ----------------------------------------------------------------------------

def test_warm_rebuild_reads_cached_format_plan(tmp_path):
    """The second engine over the same data reads the FormatPlan (and no
    selection runs); the .npz layout is the reference's; keys carry the
    backend."""
    _, t = _both(*_skewed())
    d = torch.tensor(np.random.default_rng(6).normal(
        size=(t.n_atoms, 8)).astype(np.float32))
    cache = PlanCache(str(tmp_path))
    first = fsel.choose_format(t, d, cache=cache)
    assert (cache.stats.hits, cache.stats.misses) == (0, 1)
    before = search.measurement_count()
    again = fsel.choose_format(t, d, cache=PlanCache(str(tmp_path)))
    assert search.measurement_count() == before       # no measurement
    assert dataclasses.asdict(again) == dataclasses.asdict(first)
    key = format_plan_key(
        t.atoms.numpy(), t.voxels.numpy(), t.fibers.numpy(),
        sizes=(t.n_atoms, t.n_voxels, t.n_fibers), row_tile=8, slot_tile=32,
        allowed=fsel.DEFAULT_CANDIDATES, backend="cpu", coo_executor="opt",
        sell_accept=fsel.DEFAULT_SELL_ACCEPT,
        sell_reject=fsel.DEFAULT_SELL_REJECT)
    theirs = JPlanCache(str(tmp_path)).get_format_plan(key)
    assert (theirs.format, theirs.reason) == (first.format, first.reason)
    assert theirs.stats == first.stats
    assert key != format_plan_key(
        t.atoms.numpy(), t.voxels.numpy(), t.fibers.numpy(),
        sizes=(t.n_atoms, t.n_voxels, t.n_fibers), row_tile=8, slot_tile=32,
        allowed=fsel.DEFAULT_CANDIDATES, backend="cuda", coo_executor="opt",
        sell_accept=fsel.DEFAULT_SELL_ACCEPT,
        sell_reject=fsel.DEFAULT_SELL_REJECT)
    assert key != format_plan_key(
        t.atoms.numpy(), t.voxels.numpy(), t.fibers.numpy(),
        sizes=(t.n_atoms, t.n_voxels, t.n_fibers), row_tile=8, slot_tile=32,
        allowed=fsel.DEFAULT_CANDIDATES, backend="cpu",
        coo_executor="kernel", sell_accept=fsel.DEFAULT_SELL_ACCEPT,
        sell_reject=fsel.DEFAULT_SELL_REJECT)
    # other thresholds may choose otherwise: a different key
    fsel.choose_format(t, d, cache=cache, sell_accept=-1.0, sell_reject=-0.5)
    assert cache.stats.misses == 2


@pytest.mark.parametrize("executor,fmt,lookups", [("opt", "auto", 1),
                                                  ("auto", "coo", 2)])
def test_warm_engine_rebuild_hits_its_plans(executor, fmt, lookups, tmp_path,
                                            tiny_problem):
    """format="auto" caches one FormatPlan, the auto executor two
    SpmvPlans: a second engine hits every one and binds the same plan."""
    cfg = LifeConfig(executor=executor, format=fmt, c_tile=64,
                     plan_cache_dir=str(tmp_path))
    tp = _port(tiny_problem)
    eng1 = LifeEngine(tp, cfg, device="cpu")
    assert eng1.cache_stats.hits == 0
    eng2 = LifeEngine(tp, cfg, device="cpu")
    assert (eng2.cache_stats.hits, eng2.cache_stats.misses) == (lookups, 0)
    if fmt == "auto":
        assert dataclasses.asdict(eng2.format_plan) == dataclasses.asdict(
            eng1.format_plan)
    else:
        for a, b in ((eng1.dsc_plan, eng2.dsc_plan),
                     (eng1.wc_plan, eng2.wc_plan)):
            assert (a.restructure, a.partition) == (b.restructure,
                                                    b.partition)
            np.testing.assert_array_equal(a.order, b.order)
    w = torch.rand(tp.phi.n_fibers)
    torch.testing.assert_close(eng1.matvec(w), eng2.matvec(w))


def test_format_plan_round_trips_through_the_cache(tmp_path):
    cache = PlanCache(str(tmp_path))
    plan = FormatPlan("fcoo", "autotune", dict(row_tile=8, slot_tile=32),
                      {"dsc.sell_overhead": 7.25})
    cache.put_format_plan("k", plan)
    assert dataclasses.asdict(cache.get_format_plan("k")) == \
        dataclasses.asdict(plan)
    assert PlanCache("").get_format_plan("k") is None
    assert plan.describe() == "format=fcoo (autotune; row_tile=8,slot_tile=32)"
