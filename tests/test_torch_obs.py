"""Port vs reference: observability, the H100 roofline and the SpMV bytes.

* the same seeded observations through the port's and the reference's
  registries give equal snapshots (the reservoir included);
* span nesting gives the same Chrome export shape in both packages;
* the port's disabled instruments allocate nothing (the reference's
  tracemalloc check, tests/test_obs.py);
* ``roofline()`` terms equal the reference's rescaled by the two ``HW``
  tables;
* ``roofline/spmv_bytes.py`` equals the byte formulas ``chip_smoke.py``
  phase 6 wrote inline before this module existed, on small layouts;
* the engine's and the cohort engine's spans, histograms and roofline
  gauges, and a disabled stack that records nothing;
* the plan cache's lookups by kind, equal to the reference's for the same
  sequence of engine builds.
"""
import gc
import json
import os
import tracemalloc

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.life import LifeConfig as JConfig
from repro.core.life import LifeEngine as JEngine
from repro.core.plan_cache import PlanCache as JCache
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.obs.trace import Tracer as JTracer
from repro.roofline import analysis as janalysis
from repro_torch import obs
from repro_torch.bridge import from_reference
from repro_torch.core.batched import BatchedLifeEngine
from repro_torch.core.life import LifeConfig, LifeEngine
from repro_torch.core.plan_cache import CacheStats, PlanCache
from repro_torch.obs.metrics import MetricsRegistry, quantile
from repro_torch.obs.trace import _NOOP_SPAN, Tracer
from repro_torch.roofline import analysis, spmv_bytes

TEST_SEED = int(os.environ.get("REPRO_TEST_SEED", "0"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_obs_disabled_and_clean():
    """The port's observability starts disabled and empty for every test
    (tests/conftest.py resets only the reference's)."""
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _port(p):
    ph = p.phi
    return from_reference(ph.atoms, ph.voxels, ph.fibers, ph.values,
                          ph.n_atoms, ph.n_voxels, ph.n_fibers, p.dictionary,
                          p.b, p.w_true, device="cpu", grid=p.grid)


@pytest.fixture(scope="module")
def problem(tiny_problem):
    return _port(tiny_problem)


def _both_on():
    obs.enable()
    jobs.enable()


# ----------------------------------------------------------------------------
# registries and tracers: the same as the reference's
# ----------------------------------------------------------------------------

def _observe(reg, rng_seed: int) -> dict:
    rng = np.random.default_rng(rng_seed)
    reg.counter("lk", kind="tile", outcome="hit").inc(3.0)
    reg.counter("lk", kind="tune", outcome="miss").inc(2.5)
    reg.gauge("depth").set(4.0)
    reg.gauge("depth").dec(1.5)
    small = reg.histogram("lat.small")
    big = reg.histogram("lat.big", max_samples=64, role="x")
    for v in rng.exponential(size=40):
        small.observe(v)
    for v in rng.normal(size=700):              # past the reservoir cap
        big.observe(v)
    reg.histogram("never")                      # empty: no quantiles
    return reg.snapshot()


def test_same_observations_give_the_references_snapshot():
    _both_on()
    ours = _observe(MetricsRegistry(), 7 + TEST_SEED)
    theirs = _observe(JRegistry(), 7 + TEST_SEED)
    assert ours == theirs
    assert json.dumps(ours, allow_nan=False)
    assert obs.snapshot_value(ours, "gauges", "depth") == 2.5
    big = [h for h in ours["histograms"] if h["name"] == "lat.big"][0]
    assert big["count"] == 700


def test_quantile_matches_numpy_and_the_reference():
    rng = np.random.default_rng(TEST_SEED)
    for n in (1, 2, 17, 200):
        xs = rng.normal(size=n).tolist()
        for q in (0.0, 12.5, 50.0, 95.0, 100.0):
            assert quantile(xs, q) == jobs.quantile(xs, q)
            assert quantile(xs, q) == pytest.approx(
                float(np.percentile(xs, q)), rel=1e-9, abs=1e-12)
    with pytest.raises(ValueError):
        quantile([1.0], 101.0)


def test_reset_keeps_instruments_and_total_sums_labels():
    obs.enable()
    reg = MetricsRegistry()
    c = reg.counter("kept", role="x")
    c.inc(5.0)
    reg.reset()
    assert c.value == 0.0
    c.inc(2.0)
    assert reg.counter("kept", role="x") is c
    assert reg.value("kept", role="x") == 2.0
    reg.counter("lk", kind="tile", outcome="hit").inc(3.0)
    reg.counter("lk", kind="tile", outcome="miss").inc(7.0)
    assert reg.total("lk", outcome="hit") == 3.0 and reg.total("lk") == 10.0


def _nest(t):
    with t.span("root", {"k": 1}):
        with t.span("child-a"):
            with t.span("leaf") as sp:
                sp.set_attr("bytes", 128)
        with t.span("child-b"):
            pass
    with t.span("root2"):
        pass


def _rebuild_by_containment(events):
    nodes = [dict(e, children=[]) for e in
             sorted(events, key=lambda e: (e["ts"], -e["dur"]))]
    roots, stack = [], []
    for n in nodes:
        while stack and not (stack[-1]["ts"] <= n["ts"] and
                             n["ts"] + n["dur"] <= stack[-1]["ts"]
                             + stack[-1]["dur"]):
            stack.pop()
        (stack[-1]["children"] if stack else roots).append(n)
        stack.append(n)
    return roots


def _shape(tree):
    return [(n["name"], n.get("args", n.get("attrs")), _shape(n["children"]))
            for n in tree]


def test_span_nesting_exports_the_references_chrome_shape():
    _both_on()
    ours, theirs = Tracer(), JTracer()
    _nest(ours)
    _nest(theirs)
    strip = lambda events: [{k: v for k, v in e.items()    # noqa: E731
                             if k not in ("ts", "dur")} for e in events]
    assert strip(ours.export_chrome()) == strip(theirs.export_chrome())
    assert _shape(_rebuild_by_containment(ours.export_chrome())) == \
        _shape(_rebuild_by_containment(theirs.export_chrome()))
    assert _shape(ours.export()) == _shape(theirs.export())
    payload = json.loads(ours.to_chrome_json())
    assert {e["ph"] for e in payload["traceEvents"]} == {"X"}
    assert all(e["dur"] >= 0 for e in payload["traceEvents"])
    t = Tracer(max_spans=3)
    for _ in range(5):
        with t.span("s"):
            pass
    assert len(t.roots) == 3 and t.dropped == 2


def test_disabled_instruments_allocate_nothing():
    """With the switch off, held instruments and span() allocate nothing
    that tracemalloc attributes to the obs sources (retried, as the
    reference's check is, past background allocation noise)."""
    from repro_torch.obs import metrics as metrics_mod
    from repro_torch.obs import trace as trace_mod

    reg, t = MetricsRegistry(), Tracer()
    c, g, h = reg.counter("x.count"), reg.gauge("x.gauge"), \
        reg.histogram("x.hist")
    assert not obs.enabled()
    assert t.span("anything", {"ignored": 1}) is _NOOP_SPAN

    def hot(n=500):
        for _ in range(n):
            c.inc()
            g.set(3.0)
            h.observe(1.5)
            with t.span("hot") as sp:
                sp.set_attr("k", "v")

    filters = [tracemalloc.Filter(True, metrics_mod.__file__),
               tracemalloc.Filter(True, trace_mod.__file__)]
    grew = None
    for _ in range(3):
        gc.collect()
        tracemalloc.start()
        try:
            hot()
            before = tracemalloc.take_snapshot()
            hot()
            after = tracemalloc.take_snapshot()
        finally:
            tracemalloc.stop()
        grew = [s for s in after.filter_traces(filters).compare_to(
            before.filter_traces(filters), "lineno") if s.size_diff > 0]
        if not grew:
            break
    assert not grew, f"disabled path allocated: {grew}"
    assert c.value == 0.0 and g.value == 0.0 and h.count == 0
    assert t.roots == []


# ----------------------------------------------------------------------------
# the roofline on the H100
# ----------------------------------------------------------------------------

def test_hw_is_the_h100_data_sheet():
    assert analysis.HW == dict(peak_flops=989e12, fp32_flops=67e12,
                               hbm_bw=3.35e12, link_bw=450e9)


@pytest.mark.parametrize("args", [(1e12, 2e9, 0.0, 1, 5e11),
                                  (4e14, 8e11, 3e9, 4, 1e15),
                                  (1e9, 1e12, 1e11, 2, 0.0)])
def test_roofline_terms_are_the_references_rescaled(args):
    ours = analysis.roofline(*args)
    theirs = janalysis.roofline(*args)
    for term, key in (("compute_s", "peak_flops"), ("memory_s", "hbm_bw"),
                      ("collective_s", "link_bw")):
        assert getattr(ours, term) == pytest.approx(
            getattr(theirs, term) * janalysis.HW[key] / analysis.HW[key],
            rel=1e-12)
    assert ours.useful_ratio == theirs.useful_ratio
    assert ours.bound_s == max(ours.compute_s, ours.memory_s,
                               ours.collective_s)
    assert ours.as_dict()["dominant"] == max(
        ("compute", "memory", "collective"),
        key=lambda k: getattr(ours, f"{k}_s"))
    assert analysis.mfu_fraction(ours, args[3], "prefill") == pytest.approx(
        args[4] / (args[3] * analysis.HW["peak_flops"] * ours.bound_s))


def test_model_flops_is_the_references():
    from repro_torch.configs.base import get_config
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    for kind in ("train", "prefill", "decode"):
        assert analysis.model_flops(cfg, "s", 512, 4, kind) == \
            janalysis.model_flops(cfg, "s", 512, 4, kind)


def test_bound_takes_the_larger_term():
    assert analysis.bound(3.35e12, 1.0) == (1.0, "bytes")
    assert analysis.bound(1.0, 67e12) == (1.0, "operations")
    assert analysis.bound(1.0, 989e12, analysis.HW["peak_flops"]) == (
        1.0, "operations")


# ----------------------------------------------------------------------------
# spmv_bytes: chip_smoke.py's former inline formulas, now in one module
# ----------------------------------------------------------------------------

def _layouts(problem):
    """The six kernels' operands at small tiles, as chip_smoke.py builds
    them (kernel_operands / format_operands), on the CPU."""
    from repro_torch.core.inspector import plan_tiles
    from repro_torch.core.restructure import sort_by_host
    from repro_torch.formats.fcoo import FcooPhi
    from repro_torch.formats.sell import SellPhi
    from repro_torch.kernels.ops import coo_tiles
    phi = problem.phi
    phi_v, _ = sort_by_host(phi, "voxel")
    phi_w, _ = sort_by_host(phi, "fiber")
    plans = (plan_tiles(phi_v.voxels.numpy(), phi.n_voxels, c_tile=32,
                        row_tile=8),
             plan_tiles(phi_w.fibers.numpy(), phi.n_fibers, c_tile=32,
                        row_tile=8))
    t_dsc = coo_tiles(phi_v, plans[0], phi_v.fibers, phi.n_voxels)
    t_wc = coo_tiles(phi_w, plans[1], phi_w.voxels, phi.n_fibers)
    sd = SellPhi.encode(phi, op="dsc", row_tile=8, slot_tile=32)
    sw = SellPhi.encode(phi, op="wc", row_tile=8, slot_tile=32)
    return t_dsc, t_wc, sd, sw, FcooPhi.encode(phi, c_tile=32)


def test_spmv_bytes_equal_chip_smokes_formulas(problem):
    phi, d = problem.phi, problem.dictionary
    t_dsc, t_wc, sd, sw, fc = _layouts(problem)
    nc, n_theta = phi.n_coeffs, d.shape[1]
    nv, nf = phi.n_voxels, phi.n_fibers
    d_bytes = d.numel() * d.element_size()
    tile_bytes = lambda t: 4 * (t.tile_ptr.numel()        # noqa: E731
                                + t.tile_len.numel())
    # chip_smoke.py phase 6's inline formulas, verbatim (D added by its
    # bound())
    formulas = {
        "dsc_coo": nc * 16 + tile_bytes(t_dsc) + nf * 4
        + t_dsc.n_row_blocks * t_dsc.row_tile * n_theta * 4,
        "dsc_sell": nc * 12 + sd.row_nnz.nbytes + nf * 4
        + sd.atoms.shape[0] * n_theta * 4,
        "dsc_fcoo": nc * 16 + nf * 4 + nv * n_theta * 4,
        "wc_coo": nc * 16 + tile_bytes(t_wc) + nv * n_theta * 4
        + t_wc.n_row_blocks * t_wc.row_tile * 4,
        "wc_sell": nc * 12 + sw.row_nnz.nbytes + nv * n_theta * 4
        + sw.atoms.shape[0] * 4,
        "wc_fcoo": nc * 20 + nv * n_theta * 4 + nf * 4,
    }
    kw = dict(d_bytes=d_bytes)
    ours = {
        "dsc_coo": spmv_bytes.dsc_coo(
            nc, n_theta, n_fibers=nf, n_row_blocks=t_dsc.n_row_blocks,
            n_tiles=t_dsc.tile_len.numel(), row_tile=t_dsc.row_tile, **kw),
        "dsc_sell": spmv_bytes.dsc_sell(
            nc, n_theta, n_fibers=nf, n_rows=sd.row_nnz.size,
            rows_padded=sd.atoms.shape[0], **kw),
        "dsc_fcoo": spmv_bytes.stream(nc, n_theta, n_voxels=nv,
                                      n_fibers=nf, **kw),
        "wc_coo": spmv_bytes.wc_coo(
            nc, n_theta, n_voxels=nv, n_row_blocks=t_wc.n_row_blocks,
            n_tiles=t_wc.tile_len.numel(), row_tile=t_wc.row_tile, **kw),
        "wc_sell": spmv_bytes.wc_sell(
            nc, n_theta, n_voxels=nv, n_rows=sw.row_nnz.size,
            rows_padded=sw.atoms.shape[0], **kw),
        "wc_fcoo": spmv_bytes.wc_fcoo(nc, n_theta, n_voxels=nv,
                                      n_fibers=nf, **kw),
    }
    for name, want in formulas.items():
        assert ours[name].bytes == want + d_bytes, name
        assert ours[name].flops == 2.0 * nc * n_theta + nc, name
    assert fc.n_coeffs == nc


@pytest.mark.parametrize("executor,fmt", [("kernel", "coo"),
                                          ("opt", "sell"), ("opt", "fcoo"),
                                          ("opt", "coo"), ("naive", "coo")])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_executor_work_reads_each_executors_layout(executor, fmt, dtype,
                                                   problem):
    cfg = LifeConfig(executor=executor, format=fmt, c_tile=32, row_tile=8,
                     compute_dtype=dtype, plan_cache_dir="")
    eng = LifeEngine(problem, cfg, device="cpu")
    na, n_theta = problem.dictionary.shape
    dsc, wc = spmv_bytes.executor_work(eng.executor, eng.phi, n_theta, na,
                                       dtype)
    phi, vb = problem.phi, 2 if dtype == "bf16" else 4
    kw = dict(d_bytes=na * n_theta * vb, value_bytes=vb)
    name = eng.executor.name
    if name == "kernel-sell":
        sd, sw = eng.executor.plans["sell_dsc"], eng.executor.plans["sell_wc"]
        assert dsc == spmv_bytes.dsc_sell(
            phi.n_coeffs, n_theta, n_fibers=phi.n_fibers,
            n_rows=phi.n_voxels, rows_padded=sd.atoms.shape[0], **kw)
        assert wc.bytes > dsc.bytes - phi.n_voxels * n_theta * 4
        assert sw.n_coeffs == phi.n_coeffs
    elif name == "kernel-fcoo":
        assert wc.bytes - dsc.bytes == 4 * phi.n_coeffs
    elif name == "kernel":
        tiles = eng.executor.plans["dsc_tiles"]
        assert dsc.bytes == spmv_bytes.dsc_coo(
            phi.n_coeffs, n_theta, n_fibers=phi.n_fibers,
            n_row_blocks=tiles.n_rows_padded // 8, n_tiles=tiles.n_tiles,
            row_tile=8, **kw).bytes
    else:
        assert dsc == wc == spmv_bytes.stream(
            phi.n_coeffs, n_theta, n_voxels=phi.n_voxels,
            n_fibers=phi.n_fibers, **kw)
    assert spmv_bytes.iteration_bytes(dsc, wc) == 2.0 * dsc.bytes \
        + 1.5 * wc.bytes


# ----------------------------------------------------------------------------
# the engines' instruments
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("executor,fmt", [("opt", "coo"), ("kernel", "coo"),
                                          ("opt", "sell"), ("opt", "fcoo")])
def test_engine_step_populates_histogram_and_roofline(executor, fmt,
                                                      problem):
    obs.enable()
    eng = LifeEngine(problem, LifeConfig(executor=executor, format=fmt,
                                         n_iters=4, plan_cache_dir=""),
                     device="cpu")
    name = eng.executor.name
    assert obs.histogram("engine.build.seconds").count == 1
    state, losses = eng.step(eng.init_state(), 4)
    assert state.it == 4 and losses.shape == (4,)
    assert obs.histogram("engine.step.seconds", executor=name).count == 1
    frac = obs.value("engine.roofline.fraction", executor=name, format=fmt)
    gbps = obs.value("engine.achieved_bandwidth.gbps", executor=name,
                     format=fmt)
    assert frac > 0.0
    assert gbps == pytest.approx(frac * analysis.HW["hbm_bw"] / 1e9)
    (root,) = [s for s in obs.TRACER.export() if s["name"] == "engine.step"]
    attrs = root["attrs"]
    assert (attrs["executor"], attrs["format"], attrs["k"]) == (name, fmt, 4)
    assert attrs["roofline_fraction"] == frac
    assert attrs["bytes_accessed"] == pytest.approx(
        4 * eng._op_bytes_per_iter())


def test_compaction_rebuild_recounts_the_bytes(problem):
    obs.enable()
    eng = LifeEngine(problem, LifeConfig(executor="kernel", n_iters=8,
                                         compact_every=4, plan_cache_dir=""),
                     device="cpu")
    before = eng._op_bytes_per_iter()
    eng.run()
    assert obs.histogram("engine.build.seconds").count == 2
    assert eng.phi.n_coeffs < problem.phi.n_coeffs
    assert eng._op_bytes_per_iter() < before
    assert obs.histogram("engine.step.seconds", executor="kernel").count == 2


def test_cohort_step_span_and_histogram(tiny_cohort):
    obs.enable()
    cohort = [_port(p) for p in tiny_cohort]
    eng = BatchedLifeEngine(cohort, LifeConfig(n_iters=4, plan_cache_dir=""),
                            device="cpu")
    states, losses = eng.step(eng.init_states(), 4)
    assert losses.shape == (3, 4)
    assert obs.histogram("engine.step.seconds", executor="opt").count == 1
    (root,) = [s for s in obs.TRACER.export() if s["name"] == "engine.step"]
    assert root["attrs"] == {"executor": "opt", "batched": 3, "k": 4}
    obs.disable()
    same, _ = eng.step(eng.init_states(), 4)
    assert torch.equal(same.w, states.w)
    assert obs.histogram("engine.step.seconds", executor="opt").count == 1


def test_disabled_stack_records_nothing(problem, tiny_cohort, monkeypatch):
    """While obs is off the engines record nothing and never fence the
    device (the production path)."""
    import repro_torch.core.batched as batched_mod
    import repro_torch.core.life as life_mod

    def no_fence(device):
        raise AssertionError("a disabled step fenced the device")

    monkeypatch.setattr(life_mod, "fence", no_fence)
    monkeypatch.setattr(batched_mod, "fence", no_fence)
    assert not obs.enabled()
    for fmt in ("coo", "sell"):
        eng = LifeEngine(problem, LifeConfig(executor="opt", format=fmt,
                                             n_iters=4, plan_cache_dir=""),
                         device="cpu")
        eng.step(eng.init_state(), 4)
    cohort = [_port(p) for p in tiny_cohort]
    eng = BatchedLifeEngine(cohort, LifeConfig(plan_cache_dir=""),
                            device="cpu")
    eng.step(eng.init_states(), 2)
    snap = obs.snapshot()
    assert all(c["value"] == 0.0 for c in snap["counters"])
    assert all(g["value"] == 0.0 for g in snap["gauges"])
    assert all(h["count"] == 0 for h in snap["histograms"])
    assert snap["spans"]["recorded"] == 0


def test_tune_search_records_its_span_and_counters(problem, tmp_path):
    """A cold tune="full" search records one tune.search span and its
    counters; a warm rebuild measures nothing and records nothing new."""
    obs.enable()
    cfg = LifeConfig(executor="kernel", tune="full", tune_budget=3,
                     plan_cache_dir=str(tmp_path))
    eng = LifeEngine(problem, cfg, device="cpu")
    n = len(eng.tune_plan.measurements)
    assert n == 3
    assert obs.value("tune.searches", executor="kernel") == 1.0
    assert obs.value("tune.measurements") == float(n)
    assert obs.histogram("tune.measurements.per_search").count == 1
    (span,) = [s for s in obs.TRACER.export() if s["name"] == "tune.search"]
    assert span["attrs"] == {"executor": "kernel", "candidates": n}
    LifeEngine(problem, cfg, device="cpu")
    assert obs.value("tune.searches", executor="kernel") == 1.0
    assert obs.value("plan_cache.lookups", kind="tune", outcome="hit") == 1.0


# ----------------------------------------------------------------------------
# the plan cache's lookups by kind
# ----------------------------------------------------------------------------

def test_cache_stats_record_kinds():
    s = CacheStats()
    assert s.hit_rate == 0.0 and s.lookups == 0
    s.record(True, kind="tile")
    s.record(False, kind="tile")
    assert s.lookups == 2 and s.hit_rate == 0.5
    assert obs.total("plan_cache.lookups") == 0.0     # obs off
    obs.enable()
    s.record(True, "format")
    assert obs.value("plan_cache.lookups", kind="format",
                     outcome="hit") == 1.0
    assert s.hits == 2


_BUILDS = (dict(executor="kernel"), dict(executor="kernel"),
           dict(executor="auto"), dict(executor="auto"),
           dict(executor="opt", tune="cached", predict="off"),
           dict(executor="kernel", tune="cached", predict="off"),
           dict(executor="opt", tune="full", predict="off"),
           dict(executor="opt", tune="cached", predict="off"),
           dict(executor="opt", format="auto"),
           dict(executor="opt", format="auto"))


def _lookups(total) -> dict:
    return {(kind, outcome): total("plan_cache.lookups", kind=kind,
                                   outcome=outcome)
            for kind in ("tile", "spmv", "tune", "format")
            for outcome in ("hit", "miss")}


def test_plan_cache_lookups_by_kind_equal_the_references(tiny_problem,
                                                         problem, tmp_path):
    """The same sequence of engine builds (cold and warm kernel, auto,
    tune and format="auto" builds) over one persistent cache in each
    package gives the same lookups by kind and outcome, every kind hit
    and missed."""
    _both_on()
    ours = PlanCache(str(tmp_path / "port"))
    theirs = JCache(str(tmp_path / "reference"))
    for kw in _BUILDS:
        LifeEngine(problem, LifeConfig(**kw), ours, device="cpu")
        JEngine(tiny_problem, JConfig(**kw), theirs)
    assert _lookups(obs.total) == _lookups(jobs.total)
    assert (ours.stats.hits, ours.stats.misses) == (theirs.stats.hits,
                                                    theirs.stats.misses)
    assert all(_lookups(obs.total).values())
    obs.record_cache_stats(ours.stats)
    assert obs.value("plan_cache.hit_rate") == ours.stats.hit_rate
