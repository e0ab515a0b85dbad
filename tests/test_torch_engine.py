"""Port vs reference: the executor registry, the plan cache and LifeEngine.

Every registered executor (naive, opt, opt-paper, kernel, kernel-sell,
kernel-fcoo, alto, auto, and the mesh executors shard and shard-sell at
(1, 1)) against the dense oracle and the reference's engine on
``tiny_problem``; the compaction rebuild; the config values the engine
refuses; the device policy.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.life import LifeConfig as JConfig
from repro.core.life import LifeEngine as JEngine
from repro.core.plan_cache import PlanCache as JPlanCache
from repro.core.registry import REGISTRY as JREGISTRY
from repro_torch.bridge import from_reference, to_numpy
from repro_torch.core import plan_cache
from repro_torch.core.life import (EXECUTORS, LATER_EXECUTORS, LifeConfig,
                                   LifeEngine)
from repro_torch.core.plan_cache import PlanCache, tile_plan_key
from repro_torch.core.registry import REGISTRY, planned_tiles

#: the conformance matrix of the port: every executor the port registers
PORTED = REGISTRY.names()
CFG = LifeConfig(c_tile=64, row_tile=8, plan_cache_dir="")
JCFG = JConfig(c_tile=64, row_tile=8, plan_cache_dir="")


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


def test_registry_holds_the_slice():
    assert EXECUTORS == PORTED == JREGISTRY.names() == (
        "alto", "auto", "kernel", "kernel-fcoo", "kernel-sell", "naive",
        "opt", "opt-paper", "shard", "shard-sell")
    assert REGISTRY.executors_for_format("coo") == (
        "auto", "kernel", "naive", "opt", "opt-paper", "shard")
    assert REGISTRY.executors_for_format("sell") == ("kernel-sell",
                                                     "shard-sell")
    assert REGISTRY.executors_for_format("fcoo") == ("kernel-fcoo",)
    assert REGISTRY.executors_for_format("alto") == ("alto",)
    assert {n: REGISTRY.consumes(n) for n in PORTED} == {
        n: JREGISTRY.consumes(n) for n in PORTED}
    for fmt in ("coo", "sell", "alto", "fcoo"):
        assert (REGISTRY.mesh_executor_for(fmt)
                == JREGISTRY.mesh_executor_for(fmt))
    with pytest.raises(ValueError, match="already registered"):
        REGISTRY.register("opt")(lambda *a: None)
    with pytest.raises(ValueError, match="must be one of"):
        REGISTRY.consumes("nope")


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("executor", PORTED)
def test_matvec_rmatvec_match_dense_oracle(executor, compute_dtype,
                                           tiny_problem, tiny_dense, rng):
    p = tiny_problem
    eng = LifeEngine(_port(p), dataclasses.replace(
        CFG, executor=executor, compute_dtype=compute_dtype), device="cpu")
    m = np.asarray(tiny_dense, np.float64)
    n_theta = p.dictionary.shape[1]
    w = rng.uniform(0, 1, p.phi.n_fibers).astype(np.float32)
    y = rng.normal(size=(p.phi.n_voxels, n_theta)).astype(np.float32)
    tol = (dict(rtol=2e-4, atol=2e-5) if compute_dtype == "fp32"
           else dict(rtol=2e-2, atol=2e-2))     # repro/tune/plan.py BF16_*
    got = to_numpy(eng.matvec(torch.tensor(w))).astype(np.float64)
    assert got.shape == (p.phi.n_voxels, n_theta)
    np.testing.assert_allclose(got.reshape(-1), m @ w, **tol)
    got = to_numpy(eng.rmatvec(torch.tensor(y))).astype(np.float64)
    assert got.shape == (p.phi.n_fibers,)
    np.testing.assert_allclose(got, m.T @ y.reshape(-1), **tol)


@pytest.mark.parametrize("executor", PORTED)
def test_engine_run_matches_reference_engine(executor, tiny_problem):
    """Every port executor against the reference's naive engine (the
    conformance matrix's trajectory oracle), 8 iterations."""
    p = tiny_problem
    w_ref, l_ref = JEngine(p, dataclasses.replace(JCFG, executor="naive",
                                                  n_iters=8)).run()
    eng = LifeEngine(_port(p), dataclasses.replace(CFG, executor=executor,
                                                   n_iters=8), device="cpu")
    w, losses = eng.run()
    np.testing.assert_allclose(to_numpy(losses), np.asarray(l_ref), rtol=2e-3)
    np.testing.assert_allclose(to_numpy(w), np.asarray(w_ref), rtol=2e-2,
                               atol=2e-3)
    jeng = JEngine(p, dataclasses.replace(JCFG, executor="naive"))
    assert eng.prune_stats(w) == jeng.prune_stats(jnp.asarray(to_numpy(w)))


def test_compaction_rebuild_matches_reference(tiny_problem):
    """compact_every=4 over 12 iterations: the executor is rebuilt over a
    smaller Phi, the BB parity survives the rebuild, and the trajectory
    agrees with the reference's compacting engine."""
    p = tiny_problem
    cfg = dict(n_iters=12, compact_every=4)
    jeng = JEngine(p, dataclasses.replace(JCFG, executor="kernel", **cfg))
    w_ref, l_ref = jeng.run()
    eng = LifeEngine(_port(p), dataclasses.replace(CFG, executor="kernel",
                                                   **cfg), device="cpu")
    first = eng.executor
    w, losses = eng.run()
    assert eng.executor is not first
    assert eng.phi.n_coeffs == jeng.phi.n_coeffs < p.phi.n_coeffs
    assert losses.shape == (12,)
    np.testing.assert_allclose(to_numpy(losses), np.asarray(l_ref), rtol=2e-3)
    np.testing.assert_allclose(to_numpy(w), np.asarray(w_ref), rtol=2e-2,
                               atol=2e-3)


@pytest.mark.parametrize("executor,fmt", [
    ("opt", "sell"), ("opt", "fcoo"), ("opt", "alto"), ("opt", "auto"),
    ("kernel-sell", "coo"), ("kernel-fcoo", "coo"), ("alto", "coo"),
    ("auto", "coo")])
def test_format_paths_match_reference_engine_with_compaction(executor, fmt,
                                                              tiny_problem):
    """The same executor and format through both engines, compact_every=4
    over 12 iterations: every rebuild re-encodes the smaller Phi (and
    format="auto" selects again), and the trajectories agree."""
    p = tiny_problem
    cfg = dict(executor=executor, format=fmt, n_iters=12, compact_every=4,
               slot_tile=16)
    jeng = JEngine(p, dataclasses.replace(JCFG, predict="off", **cfg))
    w_ref, l_ref = jeng.run()
    eng = LifeEngine(_port(p), dataclasses.replace(CFG, **cfg), device="cpu")
    first = eng.executor
    w, losses = eng.run()
    assert eng.executor is not first
    assert eng.executor.name == jeng.executor.name or fmt == "auto"
    assert eng.phi.n_coeffs == jeng.phi.n_coeffs < p.phi.n_coeffs
    np.testing.assert_allclose(to_numpy(losses), np.asarray(l_ref), rtol=2e-3)
    np.testing.assert_allclose(to_numpy(w), np.asarray(w_ref), rtol=2e-2,
                               atol=2e-3)


@pytest.mark.parametrize("overrides,match", [
    (dict(executor="shard-sell", shard_rows=0), "positive"),
    (dict(executor="shard", shard_rows=3, shard_cols=3),
     "needs 9 devices, have 8"),
    (dict(executor="nope"), "must be one of"),
    (dict(format="alto", shard_rows=2), "no mesh executor"),
    (dict(format="csr"), "format must be one of"),
    (dict(tune="always"), "tune must be one of"),
    (dict(compute_dtype="auto"), "searched axis"),
    (dict(compute_dtype="fp16"), "compute_dtype"),
    (dict(shard_rows=9), "needs 9 devices"),
])
def test_unsupported_config_values_raise(overrides, match, tiny_problem):
    with pytest.raises(ValueError, match=match):
        LifeEngine(_port(tiny_problem), dataclasses.replace(CFG, **overrides),
                   device="cpu")
    assert set(LATER_EXECUTORS).isdisjoint(EXECUTORS)


def test_engine_raises_without_a_card_when_no_device_given(monkeypatch,
                                                           tiny_problem):
    tp = _port(tiny_problem)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LifeEngine(tp, CFG)
    ph = tiny_problem.phi
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_reference(ph.atoms, ph.voxels, ph.fibers, ph.values, ph.n_atoms,
                       ph.n_voxels, ph.n_fibers, tiny_problem.dictionary,
                       tiny_problem.b, tiny_problem.w_true)


def test_plan_cache_warm_rebuild_and_backend_key(tmp_path, monkeypatch,
                                                 tiny_problem):
    """A second kernel engine over the same data hits both tile plans;
    $REPRO_PLAN_CACHE is honoured; keys differ by backend; the .npz layout
    is the reference's (its PlanCache reads the port's entry)."""
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path))
    cfg = dataclasses.replace(CFG, executor="kernel", plan_cache_dir=None)
    tp = _port(tiny_problem)
    eng1 = LifeEngine(tp, cfg, device="cpu")
    assert (eng1.cache_stats.hits, eng1.cache_stats.misses) == (0, 2)
    eng2 = LifeEngine(tp, cfg, device="cpu")
    assert (eng2.cache_stats.hits, eng2.cache_stats.misses) == (2, 0)
    assert eng2.cache_stats.hit_rate == 1.0
    w = torch.ones(tp.phi.n_fibers)
    assert torch.equal(eng1.matvec(w), eng2.matvec(w))

    ids = np.sort(np.random.default_rng(0).integers(0, 50, 300))
    kw = dict(c_tile=32, row_tile=8)
    assert (tile_plan_key(ids, 50, backend="cpu", **kw)
            != tile_plan_key(ids, 50, backend="cuda", **kw))
    cache = PlanCache(str(tmp_path / "x"))
    plan = planned_tiles(ids, 50, cache=cache, backend="cuda", **kw)
    key = tile_plan_key(ids, 50, backend="cuda", **kw)
    theirs = JPlanCache(str(tmp_path / "x")).get_tile_plan(key)
    for name in ("sel", "row_block", "local_row"):
        np.testing.assert_array_equal(getattr(theirs, name),
                                      getattr(plan, name))
    assert theirs.n_coeffs == plan.n_coeffs == 300
    assert PlanCache("").get_tile_plan(key) is None
    assert plan_cache.default_cache_dir() == str(tmp_path)


def test_plan_cache_size_cap_prunes_oldest(tmp_path):
    cache = PlanCache(str(tmp_path), max_bytes=1)
    for seed in range(3):
        ids = np.sort(np.random.default_rng(seed).integers(0, 40, 100))
        planned_tiles(ids, 40, c_tile=16, row_tile=4, cache=cache,
                      backend="cpu")
    assert len(list(tmp_path.glob("*.npz"))) == 1
