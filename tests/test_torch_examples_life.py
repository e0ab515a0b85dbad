"""Port vs reference: the LiFE example programs
(``repro_torch/examples``: quickstart, serve_subjects, serve_life,
serve_async, prune_connectome, distributed_life).

Each port example's ``run(device="cpu")`` at a small size is held against
the reference's own API calls on the same inputs (the generators draw the
same numpy streams, so one seed gives both packages the same problems);
the reference's scripts are not run.  Tolerances: the conformance
trajectory bound (rtol 2e-2 / atol 2e-3) for the ``auto`` executor, whose
plans each package measures on its own; the examples' own gates
elsewhere.  Without a card and without ``--device`` every example's
``main`` raises.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import obs as jobs_obs
from repro.core.batched import BatchedLifeEngine as JBatchedLifeEngine
from repro.core.life import LifeConfig as JLifeConfig
from repro.core.life import LifeEngine as JLifeEngine
from repro.data import dmri as jdmri
from repro.science import solve_to_convergence as j_solve
from repro.science import virtual_lesion as j_lesion
from repro.serve import JobFailedError as JJobFailedError
from repro.serve import LifeFrontend as JLifeFrontend
from repro.serve import LifeService as JLifeService
from repro_torch import obs
from repro_torch.examples import (distributed_life, prune_connectome,
                                  quickstart, serve_async, serve_life,
                                  serve_lm, serve_subjects, train_lm)

SMALL = dict(n_fibers=96, n_theta=16, n_atoms=24, grid=(10, 10, 10))
TRAJ_TOL = dict(rtol=2e-2, atol=2e-3)
WAIT = 600.0
EXAMPLES = (quickstart, serve_subjects, serve_life, serve_async,
            prune_connectome, distributed_life, serve_lm, train_lm)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_obs_clean():
    """The port's observability starts disabled and empty (tests/conftest.py
    resets only the reference's)."""
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _host(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("example", EXAMPLES,
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_without_a_card_raises(example, monkeypatch, capsys):
    """With no card visible and no ``--device`` an example refuses to run
    rather than dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
    assert "device:" not in capsys.readouterr().out


def test_quickstart_matches_the_reference_auto_engine(capsys):
    """Weights within the trajectory bound of the reference's ``auto``
    engine (compaction every 10 of 40 iterations); the pruning statistics
    equal; the first line names the device."""
    out = quickstart.run(**SMALL, n_iters=40, compact_every=10,
                         device="cpu")
    assert capsys.readouterr().out.splitlines()[0] == "device: cpu"
    problem = jdmri.synth_connectome(**SMALL, algorithm="PROB", seed=0)
    eng = JLifeEngine(problem, JLifeConfig(executor="auto", n_iters=40,
                                           compact_every=10))
    w, losses = eng.run()
    np.testing.assert_allclose(_host(out["w"]), np.asarray(w), **TRAJ_TOL)
    assert len(out["losses"]) == len(losses) == 40
    stats = eng.prune_stats(w)
    assert out["stats"]["kept"] == stats["kept"]
    assert out["stats"]["total"] == stats["total"]
    for k in ("precision", "recall"):
        assert abs(out["stats"][k] - stats[k]) <= 1e-6


def test_quickstart_runs_a_given_problem():
    """``run(problem=...)`` solves the problem handed to it, not the
    quickstart's own."""
    from repro_torch.data.dmri import synth_connectome
    p = synth_connectome(**SMALL, seed=4, device="cpu")
    out = quickstart.run(problem=p, n_iters=20, compact_every=0,
                         device="cpu")
    assert out["w"].shape == (SMALL["n_fibers"],)
    assert out["stats"]["total"] == SMALL["n_fibers"]
    assert torch.isfinite(out["losses"]).all() and len(out["losses"]) == 20


def test_serve_subjects_matches_the_reference_batched_engine():
    """The batched weights within the example's 1e-4 / 1e-5 of the
    reference's ``BatchedLifeEngine`` on the same cohort."""
    out = serve_subjects.run(3, **SMALL, n_iters=30, device="cpu")
    cohort = jdmri.synth_cohort(3, base_seed=0, **SMALL)
    W, losses = JBatchedLifeEngine(
        cohort, JLifeConfig(executor="opt", n_iters=30,
                            plan_cache_dir="")).run()
    np.testing.assert_allclose(_host(out["W"]), np.asarray(W), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(_host(out["losses"]), np.asarray(losses),
                               rtol=1e-4)
    assert set(out["subjects_per_s"]) == {"sequential", "batched"}


def _submit_life(svc, cohort, n_iters):
    n = len(cohort)
    for i, p in enumerate(cohort):
        svc.submit(p, job_id=f"tenant-{i}", n_iters=n_iters,
                   priority=5 if i == 1 else 0,
                   deadline=2.0 if i == 0 else None,
                   format="sell" if i == n - 1 else "coo")


def test_serve_life_resumes_and_matches_the_reference_service():
    """After the kill the resumed weights are within 1e-6 of the run
    without it (the example's gate); each tenant's final loss within rtol
    1e-4 of the reference's ``LifeService`` serving the same jobs (the last
    tenant on SELL)."""
    out = serve_life.run(3, **SMALL, n_iters=30, device="cpu")
    assert set(out["progress"]) == {"tenant-0", "tenant-1", "tenant-2"}
    assert set(out["max_dw"]) == {"tenant-0", "tenant-1", "tenant-2"}
    for jid, (w, _) in out["resumed"].items():
        w_ref = out["reference"][jid][0]
        assert float((w - w_ref).abs().max()) <= 1e-6
    cohort = jdmri.synth_cohort(3, base_seed=0, **SMALL)
    ref = JLifeService(JLifeConfig(executor="opt", n_iters=30,
                                   plan_cache_dir=""), slice_iters=10)
    _submit_life(ref, cohort, 30)
    expected = ref.run()
    for jid, (_, l_ref) in expected.items():
        np.testing.assert_allclose(_host(out["resumed"][jid][1])[-1],
                                   np.asarray(l_ref)[-1], rtol=1e-4)


def _reference_async(n_subjects: int, n_iters: int) -> tuple:
    """examples/serve_async.py's steps through the reference's API."""
    jobs_obs.enable()
    cohort = jdmri.synth_cohort(n_subjects, base_seed=0, **SMALL)
    cfg = JLifeConfig(executor="opt", n_iters=n_iters, plan_cache_dir="")
    statuses = {}
    with JLifeFrontend(cfg, slice_iters=10, max_queue=16) as fe:
        handles = {f"tenant-{i}": fe.submit_async(
            p, job_id=f"tenant-{i}", n_iters=n_iters,
            priority=5 if i == 1 else 0) for i, p in enumerate(cohort)}
        bad = fe.submit_async(dataclasses.replace(
            cohort[0], b=np.asarray(cohort[0].b)[:-3]), job_id="poisoned",
            n_iters=n_iters)
        for jid, h in handles.items():
            h.result(timeout=WAIT)
            statuses[jid] = h.status()
        assert isinstance(bad.exception(timeout=WAIT), JJobFailedError)
        statuses["poisoned"] = bad.status()
    counters = {k: jobs_obs.value(f"serve.jobs.{k}")
                for k in serve_async.COUNTERS}
    with JLifeFrontend(cfg, slice_iters=10, max_queue=1,
                       backpressure="shed", start=False) as fe:
        lo = fe.submit_async(cohort[0], job_id="lo", n_iters=4, priority=0)
        hi = fe.submit_async(cohort[1], job_id="hi", n_iters=4, priority=5)
        fe.start()
        hi.result(timeout=WAIT)
        statuses.update(lo=lo.status(), hi=hi.status())
    return statuses, counters


def test_serve_async_statuses_and_counters_equal_the_reference():
    """done for every tenant, failed for the poisoned one, shed and done
    at the one-slot queue; admitted / completed / failed equal."""
    out = serve_async.run(3, **SMALL, n_iters=20, device="cpu")
    statuses, counters = _reference_async(3, 20)
    assert out["statuses"] == statuses == {
        "tenant-0": "done", "tenant-1": "done", "tenant-2": "done",
        "poisoned": "failed", "lo": "shed", "hi": "done"}
    assert out["counters"] == counters == {"admitted": 4.0,
                                           "completed": 3.0, "failed": 1.0}
    assert isinstance(out["poisoned"], serve_async.JobFailedError)


def test_serve_async_counts_only_its_own_jobs():
    """Counters already raised by earlier work in the process are not
    reported as this run's."""
    obs.enable()
    obs.counter("serve.jobs.admitted").inc(5)
    out = serve_async.run(2, **SMALL, n_iters=10, device="cpu")
    assert out["counters"] == {"admitted": 3.0, "completed": 2.0,
                               "failed": 1.0}


def test_prune_connectome_iterations_and_lesion_match_the_reference():
    """Cold and warm iteration counts within one chunk of the reference's;
    the lesioned bundle exactly zero."""
    chunk = prune_connectome.CHUNK
    out = prune_connectome.run(96, n_theta=16, n_atoms=24, grid=(10, 10, 10),
                               device="cpu")
    problem = jdmri.synth_connectome(n_fibers=96, n_theta=16, n_atoms=24,
                                     grid=(10, 10, 10), seed=7, noise=0.02)
    cfg = JLifeConfig(executor="opt", plan_cache_dir="")
    cold = j_solve(JLifeEngine(problem, cfg), rtol=1e-5, chunk=chunk,
                   max_iters=400)
    bundle = jdmri.fiber_bundles(problem, bundle_size=8, seed=1)[0]
    np.testing.assert_array_equal(out["bundle"], bundle)
    report = j_lesion(problem, bundle, cfg, w_full=cold.w, rtol=1e-5,
                      chunk=chunk, max_iters=400)
    assert abs(out["solve"].iters - cold.iters) <= chunk
    assert abs(out["report"].iters_warm - report.iters_warm) <= chunk
    assert np.all(out["report"].w_lesioned[out["bundle"]] == 0.0)
    assert out["report"].iters_warm <= out["solve"].iters


def test_distributed_life_local_mesh_matches_the_reference_opt():
    """The (4, 2) LocalMesh's weights within the example's 1e-2 of the
    reference's single-device ``opt`` engine after the same iterations."""
    out = distributed_life.run(**SMALL, n_iters=30, device="cpu")
    assert out["cells"].startswith("8 cells of a LocalMesh")
    problem = jdmri.synth_connectome(**SMALL, algorithm="PROB", seed=0)
    w_ref, _ = JLifeEngine(problem, JLifeConfig(
        executor="opt", n_iters=30, plan_cache_dir="")).run()
    assert np.abs(out["w"] - np.asarray(w_ref)).max() < 1e-2
    assert len(out["losses"]) == 30


def test_distributed_life_on_ranks_equals_the_local_mesh(monkeypatch):
    """Where the device admits fewer cells than the mesh (one card), the
    cells run as gloo ranks; on the CPU the ranks' weights and losses are
    the local mesh's."""
    local = distributed_life.run(**SMALL, n_iters=12, device="cpu")
    monkeypatch.setattr(distributed_life, "max_cells", lambda dev: 1)
    ranks = distributed_life.run(**SMALL, n_iters=12, device="cpu")
    assert "8 gloo ranks" in ranks["cells"]
    np.testing.assert_allclose(ranks["w"], local["w"], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ranks["losses"], local["losses"], rtol=1e-6)
