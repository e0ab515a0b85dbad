"""Port vs reference: the kernel autotuner (tune/plan.py, space.py,
tuner.py), its plan-cache kind and its engine hook.

Plans, keys and search spaces against the reference's on the same
inputs; a warm rebuild makes no measurement; a ``tune="cached"`` miss
measures nothing; the bf16 contract over the port's executor x format
matrix; the candidate labels of the measurement loop.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.life import LifeConfig as JConfig
from repro.core.life import LifeEngine as JEngine
from repro.core.plan_cache import PlanCache as JPlanCache
from repro.core.plan_cache import tune_plan_key as j_tune_plan_key
from repro.tune import search as jsearch
from repro.tune.plan import TunePlan as JTunePlan
from repro.tune.space import search_space as j_search_space
from repro_torch.bridge import from_reference, to_numpy
from repro_torch.core.life import LifeConfig, LifeEngine
from repro_torch.core.plan_cache import PlanCache, tune_plan_key
from repro_torch.core.registry import REGISTRY, create_for_format
from repro_torch.formats.base import format_names
from repro_torch.tune import (BF16_ATOL, BF16_RTOL, COMPUTE_DTYPES,
                              TUNE_MODES, TunePlan, search, search_space,
                              tile_axes)
from repro_torch.tune import tuner

#: the port's conformance matrix, derived from its registry
MATRIX = [(ex, fmt) for fmt in format_names()
          for ex in REGISTRY.executors_for_format(fmt)]

CFG = LifeConfig(executor="opt", c_tile=64, row_tile=8, slot_tile=16,
                 plan_cache_dir="")
JCFG = JConfig(executor="opt", c_tile=64, row_tile=8, slot_tile=16,
               plan_cache_dir="")

_KEY_BASE = dict(sizes=(24, 40, 64), n_theta=16, executor="kernel-sell",
                 fmt="sell", backend="cpu", n_devices=1,
                 compute_dtype="fp32", budget=12)


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


def _ids():
    rng = np.random.default_rng(3)
    return (rng.integers(0, 24, 200), rng.integers(0, 40, 200),
            rng.integers(0, 64, 200))


def _no_measuring(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("measured where no measurement may be made")
    monkeypatch.setattr(search, "time_call", boom)


def _tuned_cfg(tmp_path, **kw):
    return LifeConfig(**{**dict(
        executor="opt", format="sell", slot_tile=16, row_tile=8, n_iters=2,
        tune="full", tune_budget=4, plan_cache_dir=str(tmp_path)), **kw})


# ----------------------------------------------------------------------------
# plan, space and key against the reference
# ----------------------------------------------------------------------------

def test_constants_are_the_references():
    from repro.tune import plan as jplan
    assert (BF16_RTOL, BF16_ATOL) == (jplan.BF16_RTOL, jplan.BF16_ATOL)
    assert COMPUTE_DTYPES == jplan.COMPUTE_DTYPES
    assert TUNE_MODES == jplan.TUNE_MODES
    assert (tuner.DSC_WEIGHT, tuner.WC_WEIGHT) == (2.0, 1.5)


@pytest.mark.parametrize("params,dtype,reason", [
    (dict(row_tile=16, slot_tile=64, bogus_axis=3), "bf16", "search"),
    (dict(c_tile=512, row_tile=16), "fp32", "default"),
    ({}, "fp32", "untuned"),
])
def test_plan_apply_and_describe_match_reference(params, dtype, reason):
    plan = TunePlan(executor="kernel-sell", backend="cpu", n_devices=1,
                    params=dict(params), compute_dtype=dtype, reason=reason)
    jplan = JTunePlan(executor="kernel-sell", backend="cpu", n_devices=1,
                      params=dict(params), compute_dtype=dtype, reason=reason)
    assert plan.describe() == jplan.describe()
    cfg, jcfg = plan.apply(CFG), jplan.apply(JCFG)
    for field in ("c_tile", "row_tile", "slot_tile", "seg_tile",
                  "compute_dtype"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert not hasattr(cfg, "bogus_axis")
    assert CFG.row_tile == 8 and CFG.compute_dtype == "fp32"


@pytest.mark.parametrize("budget", [None, 2, 4, 6, 12])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "auto"])
@pytest.mark.parametrize("executor", ["kernel", "kernel-sell", "opt",
                                      "naive", "auto", "shard-sell"])
def test_search_space_is_the_references(executor, dtype, budget):
    cfg = dataclasses.replace(CFG, compute_dtype=dtype, c_tile=200)
    jcfg = dataclasses.replace(JCFG, compute_dtype=dtype, c_tile=200)
    assert (search_space(executor, cfg, budget=budget)
            == j_search_space(executor, jcfg, budget=budget))


@pytest.mark.parametrize("dtype", ["fp32", "auto"])
def test_fcoo_space_drops_seg_tile_by_design(dtype):
    """kernel-fcoo searches c_tile alone: its candidates are the
    reference's with seg_tile struck out and repeats dropped, in the
    reference's order."""
    assert tile_axes("kernel-fcoo") == ("c_tile",)
    assert tile_axes("kernel") == ("c_tile", "row_tile")
    assert tile_axes("kernel-sell") == ("row_tile", "slot_tile")
    assert tile_axes("opt") == ()
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    jcfg = dataclasses.replace(JCFG, compute_dtype=dtype)
    want = []
    for cand in j_search_space("kernel-fcoo", jcfg):
        c = dict(params=dict(c_tile=cand["params"]["c_tile"]),
                 compute_dtype=cand["compute_dtype"])
        if c not in want:
            want.append(c)
    assert search_space("kernel-fcoo", cfg) == want


def test_search_space_keeps_default_under_budget():
    for budget in (2, 4, 6):
        cands = search_space("kernel-sell", CFG, budget=budget)
        assert len(cands) <= max(budget, 1)
        assert cands[0] == dict(params=dict(row_tile=8, slot_tile=16),
                                compute_dtype="fp32")


def test_tune_plan_key_is_content_addressed_and_the_references():
    ids = _ids()
    base = tune_plan_key(*ids, **_KEY_BASE)
    assert base == j_tune_plan_key(*ids, **_KEY_BASE)
    assert tune_plan_key(*(a.copy() for a in ids), **_KEY_BASE) == base
    for change in (dict(backend="cuda"), dict(n_devices=8),
                   dict(compute_dtype="bf16"), dict(compute_dtype="auto"),
                   dict(executor="kernel"), dict(fmt="coo"),
                   dict(n_theta=32), dict(sizes=(24, 40, 65)),
                   dict(budget=4), dict(mesh=(2, 1)), dict(mesh=(1, 2))):
        assert tune_plan_key(*ids, **{**_KEY_BASE, **change}) != base, change
    bumped = (ids[0].copy(), ids[1], ids[2])
    bumped[0][0] = (bumped[0][0] + 1) % 24
    assert tune_plan_key(*bumped, **_KEY_BASE) != base


def test_tune_plan_roundtrip_and_reference_reads_it(tmp_path):
    cache = PlanCache(str(tmp_path))
    plan = TunePlan(executor="kernel-sell", backend="cuda", n_devices=1,
                    params=dict(row_tile=16, slot_tile=32),
                    compute_dtype="bf16", reason="search",
                    measurements={"a": 1.5e-3, "b": 2.5e-3},
                    stats={"n_coeffs": 200.0})
    key = tune_plan_key(*_ids(), **_KEY_BASE)
    assert cache.get_tune_plan(key) is None           # cold
    cache.put_tune_plan(key, plan)
    assert cache.get_tune_plan(key) == plan
    assert cache.stats.hits == 1 and cache.stats.misses == 1
    theirs = JPlanCache(str(tmp_path)).get_tune_plan(key)
    assert dataclasses.asdict(theirs) == dataclasses.asdict(plan)
    # and the port reads what the reference writes
    JPlanCache(str(tmp_path)).put_tune_plan("j" + key, theirs)
    assert cache.get_tune_plan("j" + key) == plan
    assert PlanCache("").get_tune_plan(key) is None


# ----------------------------------------------------------------------------
# the measurement loop's labels (the reference's _label)
# ----------------------------------------------------------------------------

def test_measure_candidates_labels_are_the_references():
    """Dict candidates are labelled by sorted k=v pairs, nested dicts too,
    duplicates keyed #<index>: the reference's measurement keys."""
    cands = (search_space("kernel", dataclasses.replace(
        CFG, compute_dtype="auto"))[:5]
        + [dict(params=dict(row_tile=8, c_tile=64), compute_dtype="fp32"),
           dict(row_tile=8), dict(row_tile=8), "voxel", "fiber"])
    costs = [float(i % 3) + 0.5 for i in range(len(cands))]
    with pytest.warns(UserWarning, match="duplicate search candidate"):
        best, got = search.measure_candidates(
            cands, lambda c, it=iter(costs): next(it))
    with pytest.warns(UserWarning, match="duplicate search candidate"):
        jbest, want = jsearch.measure_candidates(
            cands, lambda c, it=iter(costs): next(it))
    assert best == jbest
    assert list(got) == list(want)
    assert got == want
    assert "compute_dtype=fp32,params=c_tile=64,row_tile=8" in got
    assert "compute_dtype=fp32,params=c_tile=64,row_tile=8#5" in got


# ----------------------------------------------------------------------------
# engine integration: full -> cached rebuild makes ZERO measurements
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("executor,fmt,extra", [
    ("opt", "sell", {}),
    ("shard-sell", "sell", dict(shard_rows=2, shard_cols=2)),
    ("opt", "fcoo", dict(c_tile=64)),
    ("kernel", "coo", dict(c_tile=64)),
])
def test_full_then_cached_zero_measurements(executor, fmt, extra, tmp_path,
                                            tiny_problem, monkeypatch):
    cfg = _tuned_cfg(tmp_path, executor=executor, format=fmt, **extra)
    tp = _port(tiny_problem)
    n0 = search.measurement_count()
    eng1 = LifeEngine(tp, cfg, device="cpu")
    plan1 = eng1.tune_plan
    assert plan1 is not None and plan1.reason == "search"
    assert plan1.executor == eng1.executor.name
    assert len(plan1.measurements) == 4           # one per candidate
    assert search.measurement_count() - n0 == 2 * 4   # its DSC and its WC
    _no_measuring(monkeypatch)
    eng2 = LifeEngine(tp, dataclasses.replace(cfg, tune="cached"),
                      device="cpu")
    assert eng2.tune_plan == plan1
    eng3 = LifeEngine(tp, cfg, device="cpu")       # warm tune="full"
    assert eng3.tune_plan == plan1
    assert tuple(sorted(plan1.params)) == tuple(sorted(tile_axes(
        plan1.executor)))


def test_tuned_plan_reaches_the_factory(tmp_path, tiny_problem):
    """The winning layout is what the executor is built with."""
    cfg = _tuned_cfg(tmp_path, executor="kernel", format="coo", c_tile=64,
                     tune_budget=12, compute_dtype="auto")
    eng = LifeEngine(_port(tiny_problem), cfg, device="cpu")
    plan = eng.tune_plan
    tiles = eng.executor.plans["dsc_tiles"]
    assert (tiles.c_tile, tiles.row_tile) == (plan.params["c_tile"],
                                              plan.params["row_tile"])
    assert eng.resolved_compute_dtype == plan.compute_dtype
    assert len(plan.measurements) == 12
    assert set(plan.stats) >= {"n_coeffs", "dsc.sell_overhead"}


def test_measurement_keys_match_reference_search(tmp_path, tiny_problem):
    """The port and the reference search the same kernel-sell candidates
    and key their measurements alike (the winner is a timing, not
    compared)."""
    cfg = _tuned_cfg(tmp_path / "p", compute_dtype="auto")
    jcfg = JConfig(executor="opt", format="sell", slot_tile=16, row_tile=8,
                   n_iters=2, tune="full", tune_budget=4, predict="off",
                   compute_dtype="auto", plan_cache_dir=str(tmp_path / "j"))
    plan = LifeEngine(_port(tiny_problem), cfg, device="cpu").tune_plan
    jplan = JEngine(tiny_problem, jcfg).tune_plan
    assert set(plan.measurements) == set(jplan.measurements)
    assert (plan.executor, plan.reason) == (jplan.executor, jplan.reason)
    assert plan.compute_dtype in COMPUTE_DTYPES
    assert (plan.backend, plan.n_devices) == ("cpu", 1)


def test_cached_miss_uses_defaults_without_measuring(tmp_path, tiny_problem,
                                                     monkeypatch):
    _no_measuring(monkeypatch)
    cfg = _tuned_cfg(tmp_path, tune="cached")
    tp = _port(tiny_problem)
    plan = LifeEngine(tp, cfg, device="cpu").tune_plan
    assert plan.reason == "untuned"
    assert plan.params == dict(row_tile=8, slot_tile=16)
    assert plan.compute_dtype == "fp32"
    # the miss persisted nothing: a later "cached" engine still misses
    assert LifeEngine(tp, cfg, device="cpu").tune_plan.reason == "untuned"
    # "auto" resolves to fp32 on a miss
    auto = LifeEngine(tp, dataclasses.replace(cfg, compute_dtype="auto"),
                      device="cpu")
    assert auto.resolved_compute_dtype == "fp32"


def test_degenerate_search_space_persists_default_plan(tmp_path,
                                                       tiny_problem,
                                                       monkeypatch):
    _no_measuring(monkeypatch)
    cfg = LifeConfig(executor="opt", n_iters=2, tune="full",
                     plan_cache_dir=str(tmp_path))
    tp = _port(tiny_problem)
    assert LifeEngine(tp, cfg, device="cpu").tune_plan.reason == "default"
    eng2 = LifeEngine(tp, dataclasses.replace(cfg, tune="cached"),
                      device="cpu")
    assert eng2.tune_plan.reason == "default"        # a warm hit


def test_backend_change_is_clean_miss(tmp_path, tiny_problem, monkeypatch):
    cfg = _tuned_cfg(tmp_path)
    tp = _port(tiny_problem)
    LifeEngine(tp, cfg, device="cpu")                # tuned, under "cpu"
    monkeypatch.setattr(tuner, "backend_name", lambda device: "cuda")
    eng = LifeEngine(tp, dataclasses.replace(cfg, tune="cached"),
                     device="cpu")
    assert eng.tune_plan.reason == "untuned"         # a miss, not stale
    assert eng.tune_plan.backend == "cuda"


def test_dtype_change_is_clean_miss(tmp_path, tiny_problem, monkeypatch):
    cfg = _tuned_cfg(tmp_path)
    tp = _port(tiny_problem)
    LifeEngine(tp, cfg, device="cpu")                # fp32-keyed plan
    _no_measuring(monkeypatch)
    eng = LifeEngine(tp, dataclasses.replace(cfg, tune="cached",
                                             compute_dtype="bf16"),
                     device="cpu")
    assert eng.tune_plan.reason == "untuned"


def test_compaction_rebuild_searches_again(tmp_path, tiny_problem):
    """The key is content-addressed, so a compaction rebuild under
    tune="full" searches the compacted Phi again (the reference's
    behaviour)."""
    cfg = _tuned_cfg(tmp_path, n_iters=8, compact_every=4)
    eng = LifeEngine(_port(tiny_problem), cfg, device="cpu")
    n0 = search.measurement_count()
    eng.run()
    assert eng.phi.n_coeffs < tiny_problem.phi.n_coeffs
    assert search.measurement_count() - n0 == 2 * 4
    assert eng.tune_plan.reason == "search"


@pytest.mark.parametrize("overrides", [
    dict(tune="off", compute_dtype="auto"),
    dict(tune="always"),
    dict(compute_dtype="fp16"),
    dict(predict="sometimes"),
])
def test_invalid_tuning_raises_the_references_errors(overrides,
                                                     tiny_problem):
    with pytest.raises(ValueError) as ours:
        LifeEngine(_port(tiny_problem), dataclasses.replace(CFG, **overrides),
                   device="cpu")
    with pytest.raises(ValueError) as theirs:
        JEngine(tiny_problem, dataclasses.replace(JCFG, **overrides))
    assert str(ours.value) == str(theirs.value)


# ----------------------------------------------------------------------------
# bf16 storage, fp32 accumulation, over the whole matrix
# ----------------------------------------------------------------------------

def _make_executor(name, fmt, problem, cfg):
    if fmt == "coo":
        return REGISTRY.create(name, problem.phi, problem, cfg, PlanCache(""))
    return create_for_format(problem.phi, problem, cfg, PlanCache(""))


@pytest.mark.parametrize("executor,fmt", MATRIX)
def test_bf16_within_documented_atol_of_fp32(executor, fmt, tiny_problem,
                                             rng):
    p = _port(tiny_problem)
    n_theta = p.dictionary.shape[1]
    w = torch.tensor(rng.uniform(0, 1, p.phi.n_fibers), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=(p.phi.n_voxels, n_theta)),
                     dtype=torch.float32)
    outs = {}
    for dt in ("fp32", "bf16"):
        cfg = dataclasses.replace(CFG, executor=executor, format=fmt,
                                  compute_dtype=dt)
        ex = _make_executor(executor, fmt, p, cfg)
        mv, rmv = ex.matvec(w), ex.rmatvec(y)
        assert mv.dtype == rmv.dtype == torch.float32
        outs[dt] = (to_numpy(mv).astype(np.float64),
                    to_numpy(rmv).astype(np.float64))
    np.testing.assert_allclose(outs["bf16"][0], outs["fp32"][0],
                               rtol=BF16_RTOL, atol=BF16_ATOL,
                               err_msg=f"{executor}/{fmt} matvec")
    np.testing.assert_allclose(outs["bf16"][1], outs["fp32"][1],
                               rtol=BF16_RTOL,
                               atol=BF16_ATOL * max(
                                   1.0, np.abs(outs["fp32"][1]).max()),
                               err_msg=f"{executor}/{fmt} rmatvec")


@pytest.mark.parametrize("fmt,executor", [("sell", "opt"), ("fcoo", "opt"),
                                          ("coo", "kernel")])
def test_tuned_engine_matches_oracle(fmt, executor, tmp_path, tiny_problem,
                                     tiny_dense, rng):
    """Whatever layout and dtype the search picks, the tuned executor
    still meets the conformance contract (BF16 bounds cover both)."""
    eng = LifeEngine(_port(tiny_problem), _tuned_cfg(
        tmp_path, executor=executor, format=fmt, c_tile=64,
        compute_dtype="auto"), device="cpu")
    m = np.asarray(tiny_dense, np.float64)
    w = rng.uniform(0, 1, tiny_problem.phi.n_fibers).astype(np.float32)
    got = to_numpy(eng.matvec(torch.tensor(w))).astype(np.float64)
    np.testing.assert_allclose(got.reshape(-1), m @ w, rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    y = rng.normal(size=(tiny_problem.phi.n_voxels,
                         tiny_problem.dictionary.shape[1])).astype(np.float32)
    got = to_numpy(eng.rmatvec(torch.tensor(y))).astype(np.float64)
    want = m.T @ y.reshape(-1)
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                               atol=BF16_ATOL * max(1.0, np.abs(want).max()))
