"""Port vs reference: learned zero-measurement selection (``repro_torch.learn``).

The reference's tests/test_learn.py case by case on the port over the CPU
(with its mesh case, since the mesh slice, ROADMAP A13): the feature
schema, the numpy models, harvesting through ``PlanCache.iter_plans``, the
predicted cold start with zero measurements, background refinement that
overwrites predicted plans in place, and the frontend's idle-tick drain.
Then the two packages side by side: equal feature vectors bit for bit,
equal fitted models, ``predictor.json`` read across packages, the port's
harvest of a reference-written cache, ``iter_plans`` over one directory,
and the same predicted plans from the same predictor with zero
measurements (tune groups carry the backend, ``cpu`` in both packages
here).
"""
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.core.inspector import phi_stats as j_phi_stats
from repro.core.life import LifeConfig as JConfig
from repro.core.life import LifeEngine as JEngine
from repro.core.plan_cache import PlanCache as JPlanCache
from repro.learn import CentroidClassifier as JCentroid
from repro.learn import NearestExample as JNearest
from repro.learn import Predictor as JPredictor
from repro.learn import feature_vector as j_feature_vector
from repro.learn import harvest as j_harvest
from repro.learn import load_predictor as j_load_predictor
from repro.learn import train_predictor as j_train_predictor
from repro.tune import search as j_search
from repro_torch import obs
from repro_torch.bridge import from_reference
from repro_torch.core.inspector import phi_stats
from repro_torch.core.life import LifeConfig, LifeEngine
from repro_torch.core.plan_cache import PlanCache
from repro_torch.data.dmri import synth_connectome
from repro_torch.formats import select as fsel
from repro_torch.formats.base import FormatPlan
from repro_torch.learn import (FEATURE_NAMES, CentroidClassifier,
                               NearestExample, Predictor, clear_load_memo,
                               feature_vector, harvest, load_predictor,
                               predictor_path, refine, run_pending,
                               train_predictor)
from repro_torch.tune import search as tsearch
from repro_torch.tune.plan import TunePlan

TEST_SEED = int(os.environ.get("REPRO_TEST_SEED", "0"))

TRAIN_SPECS = (
    dict(n_fibers=96, n_theta=16, n_atoms=24, grid=(8, 8, 8),
         algorithm="PROB", seed=71),
    dict(n_fibers=128, n_theta=16, n_atoms=24, grid=(8, 8, 8),
         algorithm="DET", seed=72),
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_learn_state_clean():
    """The port's refine queue, predictor memo and observability start
    empty for every test (tests/conftest.py resets only the
    reference's)."""
    refine.QUEUE.clear()
    refine.QUEUE.last_error = None
    clear_load_memo()
    obs.disable()
    obs.reset()
    yield
    refine.QUEUE.clear()
    refine.QUEUE.last_error = None
    clear_load_memo()
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


def _boom(*a, **k):
    raise AssertionError("timing measurement on a zero-measurement path")


def _train_cfg(cache_dir, **kw):
    base = dict(executor="opt", format="auto", n_iters=1, tune="full",
                compute_dtype="auto", tune_budget=4, predict="off",
                plan_cache_dir=str(cache_dir))
    base.update(kw)
    return LifeConfig(**base)


def _trained_cache(cache_dir, **kw):
    """Fill ``cache_dir`` with measured plans for the training fleet and
    train the predictor beside them."""
    for spec in TRAIN_SPECS:
        LifeEngine(synth_connectome(**spec, device="cpu"),
                   _train_cfg(cache_dir, **kw), device="cpu")
    cache = PlanCache(str(cache_dir))
    return cache, train_predictor(cache)


def _j_trained_cache(cache_dir, **kw):
    """The reference's own training fleet in ``cache_dir``."""
    from repro.data.dmri import synth_connectome as j_synth
    base = dict(executor="opt", format="auto", n_iters=1, tune="full",
                compute_dtype="auto", tune_budget=4, predict="off",
                plan_cache_dir=str(cache_dir))
    base.update(kw)
    for spec in TRAIN_SPECS:
        JEngine(j_synth(**spec), JConfig(**base))
    cache = JPlanCache(str(cache_dir))
    return cache, j_train_predictor(cache)


# ----------------------------------------------------------------------------
# features
# ----------------------------------------------------------------------------

def test_feature_vector_schema(problem):
    stats = phi_stats(problem.phi)
    x = feature_vector(stats)
    assert x is not None and x.shape == (len(FEATURE_NAMES),)
    assert np.all(np.isfinite(x)) and np.all(x >= 0.0)   # log1p of >= 0
    partial = dict(stats)
    del partial["dsc.run_p99"]
    assert feature_vector(partial) is None
    assert feature_vector(dict(stats, n_coeffs=float("nan"))) is None


def test_feature_vector_equals_reference_bit_for_bit(tiny_problem,
                                                     tiny_cohort):
    """The port's phi_stats -> feature_vector is the reference's, bit for
    bit, so either package's predictor scores the other's features."""
    for p in [tiny_problem] + list(tiny_cohort):
        for row_tile, slot_tile in ((8, 32), (4, 16)):
            got = feature_vector(phi_stats(_port(p).phi, row_tile=row_tile,
                                           slot_tile=slot_tile))
            want = j_feature_vector(j_phi_stats(p.phi, row_tile=row_tile,
                                                slot_tile=slot_tile))
            assert got.dtype == want.dtype == np.float64
            np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------------
# models
# ----------------------------------------------------------------------------

def _toy_training_set():
    r = np.random.default_rng(9)
    a = r.normal(loc=0.0, size=(10, 4))
    b = r.normal(loc=6.0, size=(10, 4))
    x = np.vstack([a, b])
    y = ["coo"] * 10 + ["sell"] * 10
    return x, y, a, b


def test_centroid_classifier_predicts_and_respects_allowed():
    x, y, a, b = _toy_training_set()
    clf = CentroidClassifier.fit(x, y)
    assert clf.predict(a[0]) == "coo"
    assert clf.predict(b[0]) == "sell"
    assert clf.predict(a[0], allowed=("sell",)) == "sell"
    assert clf.predict(a[0], allowed=("alto", "fcoo")) is None
    assert clf.predict(a[0], allowed=()) is None


def test_nearest_example_replays_group_payloads():
    r = np.random.default_rng(11)
    x = r.normal(size=(4, 3))
    keys = [NearestExample.group_key("kernel-sell", "cpu")] * 2 + \
           [NearestExample.group_key("opt", "cpu")] * 2
    payloads = [dict(row_tile=8, slot_tile=16, compute_dtype="fp32"),
                dict(row_tile=16, slot_tile=32, compute_dtype="bf16"),
                dict(compute_dtype="fp32"), dict(compute_dtype="bf16")]
    nn = NearestExample.fit(x, keys, payloads)
    assert nn.predict(x[1], executor="kernel-sell", backend="cpu") == \
        payloads[1]
    assert nn.predict(x[0], executor="opt", backend="cpu") in payloads[2:]
    assert nn.predict(x[0], executor="alto", backend="cpu") is None
    # the port's backends are cpu and cuda: a card's example never
    # answers on the CPU
    assert nn.predict(x[1], executor="kernel-sell", backend="cuda") is None


def test_fitted_models_equal_reference_json():
    """The same examples fit to the same JSON in both packages."""
    r = np.random.default_rng(21 + TEST_SEED)
    n_feat = len(FEATURE_NAMES)
    x = np.vstack([r.normal(loc=0.0, size=(7, n_feat)),
                   r.normal(loc=4.0, size=(5, n_feat))])
    y = ["coo"] * 4 + ["fcoo"] * 3 + ["sell"] * 5
    keys = ["kernel-sell@cpu"] * 6 + ["kernel@cpu"] * 6
    payloads = [dict(row_tile=int(4 << (i % 2)), slot_tile=32,
                     compute_dtype=("fp32", "bf16")[i % 2])
                for i in range(12)]
    assert (CentroidClassifier.fit(x, y).to_json()
            == JCentroid.fit(x, y).to_json())
    assert (NearestExample.fit(x, keys, payloads).to_json()
            == JNearest.fit(x, keys, payloads).to_json())
    got = Predictor(CentroidClassifier.fit(x, y),
                    NearestExample.fit(x, keys, payloads), 12, 12)
    want = JPredictor(JCentroid.fit(x, y),
                      JNearest.fit(x, keys, payloads), 12, 12)
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())


def test_predictor_json_roundtrip(tmp_path):
    r = np.random.default_rng(13)
    n_feat = len(FEATURE_NAMES)
    x = np.vstack([r.normal(loc=0.0, size=(8, n_feat)),
                   r.normal(loc=6.0, size=(8, n_feat))])
    y = ["coo"] * 8 + ["sell"] * 8
    pred = Predictor(format_model=CentroidClassifier.fit(x, y),
                     n_format_examples=len(y))
    blob = json.dumps(pred.to_json())
    back = Predictor.from_json(json.loads(blob))
    stats = {name: float(i + 1) for i, name in enumerate(FEATURE_NAMES)}
    assert (back.predict_format(stats, allowed=("coo", "sell"))
            == pred.predict_format(stats, allowed=("coo", "sell")))
    stale = json.loads(blob)
    stale["schema"] = -1
    assert Predictor.from_json(stale) is None
    stale = json.loads(blob)
    stale["feature_names"] = list(reversed(stale["feature_names"]))
    assert Predictor.from_json(stale) is None


# ----------------------------------------------------------------------------
# harvest + train + load
# ----------------------------------------------------------------------------

def test_harvest_excludes_non_training_reasons(tmp_path, problem):
    cache = PlanCache(str(tmp_path / "c"))
    stats = phi_stats(problem.phi)
    params = dict(row_tile=8, slot_tile=32)
    cache.put_format_plan("k1", FormatPlan("sell", "heuristic", params, stats))
    cache.put_format_plan("k2", FormatPlan("coo", "autotune", params, stats))
    cache.put_format_plan("k3", FormatPlan("alto", "explicit", params, stats))
    cache.put_format_plan("k4", FormatPlan("coo", "predicted", params, stats))
    cache.put_format_plan("k5", FormatPlan("coo", "heuristic", params, {}))
    fmt, tune = harvest(cache)
    assert sorted(lab for _, lab in fmt) == ["coo", "sell"]
    assert tune == []


def test_train_and_load_predictor(tmp_path, problem):
    cache, predictor = _trained_cache(tmp_path / "train")
    assert predictor is not None
    assert predictor.n_format_examples >= 2
    assert predictor.n_tune_examples >= 2      # the dtype axis searches
    loaded = load_predictor(cache.directory)
    assert loaded is not None
    assert loaded.n_format_examples == predictor.n_format_examples
    stats = phi_stats(problem.phi)
    assert loaded.predict_format(stats, allowed=("coo", "sell", "alto",
                                                 "fcoo")) is not None
    empty = PlanCache(str(tmp_path / "empty"))
    assert train_predictor(empty) is None
    assert load_predictor(empty.directory) is None


def test_predictor_survives_npz_pruning(tmp_path, problem):
    """Pruning by the cache's size cap touches only .npz entries."""
    cache, _ = _trained_cache(tmp_path / "train")
    capped = PlanCache(cache.directory, max_bytes=1)
    capped.put_format_plan(
        "evictor", FormatPlan("coo", "heuristic",
                              dict(row_tile=8, slot_tile=32),
                              phi_stats(problem.phi)))
    assert load_predictor(cache.directory) is not None


def _plans(pairs):
    out = []
    for kind, plan in pairs:
        d = dataclasses.asdict(plan)
        out.append((kind, json.dumps(d, sort_keys=True)))
    return out


def test_iter_plans_matches_reference(tmp_path, problem):
    """PlanCache.iter_plans yields the reference's (kind, plan) list over
    one directory: FormatPlans and TunePlans only, structural
    classification, corrupt and foreign files skipped, no lookups
    counted."""
    d = str(tmp_path / "c")
    cache = PlanCache(d)
    stats = phi_stats(problem.phi)
    cache.put_format_plan("a", FormatPlan("sell", "heuristic",
                                          dict(row_tile=8, slot_tile=32),
                                          stats))
    cache.put_tune_plan("b", TunePlan(
        executor="kernel-sell", backend="cpu", n_devices=1,
        params=dict(row_tile=4, slot_tile=16), compute_dtype="bf16",
        reason="search", measurements={"x": 1.5e-3}, stats=stats))
    cache.put_tune_plan("c", TunePlan(
        executor="opt", backend="cpu", n_devices=1, params={},
        compute_dtype="fp32", reason="default"))
    LifeEngine(problem, LifeConfig(executor="kernel", c_tile=64,
                                   plan_cache_dir=d), device="cpu")
    with open(os.path.join(d, "corrupt.npz"), "wb") as f:
        f.write(b"not a zip")
    with open(os.path.join(d, "notes.txt"), "w") as f:
        f.write("foreign")
    got = list(cache.iter_plans())
    want = list(JPlanCache(d).iter_plans())
    assert [k for k, _ in got] == [k for k, _ in want]
    assert sorted(k for k, _ in got) == ["format", "tune", "tune"]
    assert _plans(got) == _plans(want)
    assert cache.stats.lookups == 0
    assert list(PlanCache("").iter_plans()) == []


def test_harvest_of_reference_cache_equals_reference(tmp_path):
    """The port's harvest over a cache directory the reference wrote
    yields the reference's examples."""
    jcache, _ = _j_trained_cache(tmp_path / "ref")
    got_f, got_t = harvest(PlanCache(jcache.directory))
    want_f, want_t = j_harvest(jcache)
    assert len(got_f) == len(want_f) >= 2 and len(got_t) == len(want_t) >= 2
    for (gx, gl), (wx, wl) in zip(got_f, want_f):
        np.testing.assert_array_equal(gx, wx)
        assert gl == wl
    for (gx, gk, gp), (wx, wk, wp) in zip(got_t, want_t):
        np.testing.assert_array_equal(gx, wx)
        assert (gk, gp) == (wk, wp)


def test_predictor_json_crosses_packages(tmp_path, tiny_problem):
    """A predictor.json written by either package loads in the other and
    gives the same predictions."""
    jcache, jpred = _j_trained_cache(tmp_path / "ref")
    pcache, ppred = _trained_cache(tmp_path / "port")
    stats = [j_phi_stats(p.phi) for p in (tiny_problem,)] + [
        phi_stats(synth_connectome(**dict(spec, seed=spec["seed"] + 10),
                                   device="cpu").phi)
        for spec in TRAIN_SPECS]
    allowed = ("coo", "sell", "alto", "fcoo")
    for writer, reader_port, reader_ref in (
            (jcache.directory, load_predictor, j_load_predictor),
            (pcache.directory, load_predictor, j_load_predictor)):
        got, want = reader_port(writer), reader_ref(writer)
        assert got is not None and want is not None
        assert json.dumps(got.to_json()) == json.dumps(want.to_json())
        for s in stats:
            assert (got.predict_format(s, allowed=allowed)
                    == want.predict_format(s, allowed=allowed))
            for ex in ("opt", "kernel-sell", "kernel-fcoo", "alto"):
                assert (got.predict_tune(s, ex, "cpu")
                        == want.predict_tune(s, ex, "cpu"))


# ----------------------------------------------------------------------------
# the cold-start contract
# ----------------------------------------------------------------------------

def test_predicted_cold_start_zero_measurements(tmp_path, problem,
                                                monkeypatch):
    cache, predictor = _trained_cache(tmp_path / "train")
    assert predictor is not None
    n0 = tsearch.measurement_count()
    monkeypatch.setattr(tsearch, "time_call", _boom)
    cfg = LifeConfig(executor="opt", format="auto", n_iters=2, tune="cached",
                     compute_dtype="auto", plan_cache_dir=cache.directory)
    eng = LifeEngine(problem, cfg, device="cpu")
    assert tsearch.measurement_count() == n0
    assert eng.format_plan.reason == "predicted"
    assert eng.format_plan.format in ("coo", "sell", "alto", "fcoo")
    w, losses = eng.run()
    assert losses[-1] <= losses[0]


def test_predicted_tune_plan_zero_measurements(tmp_path, problem,
                                               monkeypatch):
    cache, predictor = _trained_cache(tmp_path / "train", format="sell",
                                      slot_tile=16)
    assert predictor is not None and predictor.tune_model is not None
    monkeypatch.setattr(tsearch, "time_call", _boom)
    obs.enable()
    cfg = LifeConfig(executor="opt", format="sell", slot_tile=16, n_iters=1,
                     tune="cached", compute_dtype="auto",
                     plan_cache_dir=cache.directory)
    eng = LifeEngine(problem, cfg, device="cpu")
    plan = eng.tune_plan
    assert plan is not None and plan.reason == "predicted"
    assert plan.executor == "kernel-sell" and plan.backend == "cpu"
    assert set(plan.params) == {"row_tile", "slot_tile"}
    assert plan.compute_dtype in ("fp32", "bf16")
    assert obs.value("learn.predict", kind="tune", outcome="hit") == 1.0
    eng2 = LifeEngine(problem, dataclasses.replace(cfg), device="cpu")
    assert eng2.tune_plan == plan


def test_predicted_format_respects_allowed(tmp_path, problem):
    """Predicted plans always name a format from the caller's allowed or
    mesh-capable set, even when the model's favourite class is excluded
    from it."""
    from repro_torch.core.registry import REGISTRY
    cache, predictor = _trained_cache(tmp_path / "train")
    assert predictor is not None
    d = problem.dictionary
    for allowed in (("coo",), ("alto",), ("coo", "fcoo")):
        plan = fsel.choose_format(problem.phi, d, allowed=allowed,
                                  predictor=predictor)
        assert plan.format in allowed
    # a multi-cell mesh restricts "auto" to mesh-capable formats before
    # the predictor sees the candidate set
    cfg = LifeConfig(format="auto", shard_rows=2, shard_cols=1,
                     plan_cache_dir=cache.directory, tune="off")
    plan = fsel.resolve_format(problem.phi, problem, cfg,
                               cache=PlanCache(cache.directory))
    assert REGISTRY.mesh_executor_for(plan.format) is not None


def test_selection_determinism_across_rebuilds(tmp_path, problem):
    cfg = _train_cfg(tmp_path / "c", format="auto")
    engines = [LifeEngine(problem, cfg, device="cpu") for _ in range(3)]
    plans = [e.format_plan for e in engines]
    tunes = [e.tune_plan for e in engines]
    assert plans[0] == plans[1] == plans[2]
    assert tunes[0] == tunes[1] == tunes[2]
    assert tunes[0] is not None and tunes[0].reason in ("search", "default")


def test_predicted_cold_start_same_as_reference(tmp_path, tiny_problem,
                                                monkeypatch):
    """With the same predictor.json, both packages predict the same format
    and the same tune params with zero measurements."""
    _j_trained_cache(tmp_path / "train", format="auto")
    jcache, jpred = _j_trained_cache(tmp_path / "train", format="sell",
                                     slot_tile=16)
    assert "kernel-sell@cpu" in jpred.tune_model.groups
    for mod in (tsearch, j_search):
        monkeypatch.setattr(mod, "time_call", _boom)
    for fmt in ("auto", "sell"):
        port_dir, ref_dir = tmp_path / f"p-{fmt}", tmp_path / f"r-{fmt}"
        for d in (port_dir, ref_dir):
            d.mkdir()
            with open(predictor_path(str(d)), "w") as f, \
                    open(predictor_path(jcache.directory)) as src:
                f.write(src.read())
        kw = dict(executor="opt", format=fmt, n_iters=1, tune="cached",
                  compute_dtype="auto", slot_tile=16)
        eng = LifeEngine(_port(tiny_problem),
                         LifeConfig(plan_cache_dir=str(port_dir), **kw),
                         device="cpu")
        jeng = JEngine(tiny_problem, JConfig(plan_cache_dir=str(ref_dir),
                                             **kw))
        if fmt == "auto":
            assert eng.format_plan.reason == jeng.format_plan.reason == \
                "predicted"
            assert eng.format_plan.format == jeng.format_plan.format
            assert eng.format_plan.stats == jeng.format_plan.stats
        got, want = eng.tune_plan, jeng.tune_plan
        assert got.reason == want.reason
        assert (got.executor, got.backend, got.params, got.compute_dtype) \
            == (want.executor, want.backend, want.params, want.compute_dtype)
        if fmt == "sell":
            assert got.reason == "predicted"


# ----------------------------------------------------------------------------
# background refinement
# ----------------------------------------------------------------------------

def test_refine_queue_dedups_and_survives_failure():
    q = refine.RefineQueue(max_tasks=2)
    ran = []
    assert q.push("format", "k", lambda: ran.append(1))
    assert not q.push("format", "k", lambda: ran.append(2))
    assert q.push("tune", "k", lambda: 1 / 0)
    assert not q.push("format", "k2", lambda: None)           # full
    assert len(q) == 2
    assert q.run_one() and ran == [1]
    assert q.last_error is None
    assert q.run_one()            # the failing task runs, is dropped, no raise
    assert isinstance(q.last_error, ZeroDivisionError)
    assert not q.run_one() and len(q) == 0


def test_refinement_upgrades_predicted_plan_in_place(tmp_path, problem,
                                                     monkeypatch):
    cache, _ = _trained_cache(tmp_path / "train", format="sell", slot_tile=16)
    cfg = LifeConfig(executor="opt", format="sell", slot_tile=16, n_iters=1,
                     tune="cached", compute_dtype="auto",
                     plan_cache_dir=cache.directory)
    monkeypatch.setattr(tsearch, "time_call", _boom)
    eng = LifeEngine(problem, cfg, device="cpu")
    assert eng.tune_plan.reason == "predicted"
    assert len(refine.QUEUE) >= 1
    monkeypatch.undo()            # refinement is allowed to measure
    assert run_pending() >= 1
    assert refine.QUEUE.last_error is None
    monkeypatch.setattr(tsearch, "time_call", _boom)
    eng2 = LifeEngine(problem, cfg, device="cpu")
    assert eng2.tune_plan.reason == "search"
    assert eng2.tune_plan.measurements


def test_format_refinement_upgrades_predicted_plan(tmp_path, problem,
                                                   monkeypatch):
    cache, predictor = _trained_cache(tmp_path / "train")
    fresh = PlanCache(cache.directory)
    monkeypatch.setattr(fsel, "_measure_formats", _boom)
    plan = fsel.choose_format(problem.phi, problem.dictionary, cache=fresh,
                              predictor=predictor)
    assert plan.reason == "predicted"
    assert len(refine.QUEUE) >= 1
    monkeypatch.undo()
    assert run_pending() >= 1
    assert refine.QUEUE.last_error is None
    upgraded = fsel.choose_format(problem.phi, problem.dictionary,
                                  cache=fresh, predictor=predictor)
    assert upgraded.reason in ("heuristic", "autotune")


def test_cache_hit_on_predicted_plan_reenqueues_refinement(tmp_path, problem,
                                                           monkeypatch):
    cache, predictor = _trained_cache(tmp_path / "train")
    fresh = PlanCache(cache.directory)
    monkeypatch.setattr(fsel, "_measure_formats", _boom)
    plan = fsel.choose_format(problem.phi, problem.dictionary, cache=fresh,
                              predictor=predictor)
    assert plan.reason == "predicted"
    refine.QUEUE.clear()          # a process restart
    hit = fsel.choose_format(problem.phi, problem.dictionary, cache=fresh,
                             predictor=predictor)
    assert hit.reason == "predicted"
    assert len(refine.QUEUE) == 1


def test_frontend_idle_tick_drains_refine_queue():
    from repro_torch.serve.frontend import LifeFrontend
    ran = []
    refine.QUEUE.push("format", "idle-test", lambda: ran.append(1))
    with LifeFrontend(LifeConfig(n_iters=1, plan_cache_dir=""),
                      idle_wait=0.001, device="cpu") as fe:
        deadline = time.monotonic() + 5.0
        while not ran and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fe.service is not None
    assert ran == [1]
    assert len(refine.QUEUE) == 0


def test_frontend_refine_disabled_leaves_queue():
    from repro_torch.serve.frontend import LifeFrontend
    ran = []
    refine.QUEUE.push("format", "disabled-test", lambda: ran.append(1))
    with LifeFrontend(LifeConfig(n_iters=1, plan_cache_dir=""),
                      idle_wait=0.001, refine=False, device="cpu"):
        time.sleep(0.1)
    assert ran == [] and len(refine.QUEUE) == 1


# ----------------------------------------------------------------------------
# config surface
# ----------------------------------------------------------------------------

def test_predict_off_disables_the_rung(tmp_path, problem):
    cache, predictor = _trained_cache(tmp_path / "train")
    assert predictor is not None
    cfg = LifeConfig(executor="opt", format="auto", n_iters=1, tune="cached",
                     predict="off", plan_cache_dir=cache.directory)
    eng = LifeEngine(problem, cfg, device="cpu")
    assert eng.format_plan.reason in ("heuristic", "autotune")
    assert eng.tune_plan.reason != "predicted"


def test_predict_validation():
    from repro_torch.tune.tuner import validate_config
    with pytest.raises(ValueError, match="predict"):
        validate_config(LifeConfig(predict="sometimes"))


def test_predictor_file_location(tmp_path):
    assert predictor_path(str(tmp_path)).endswith("predictor.json")
