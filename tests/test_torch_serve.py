"""Port vs reference: the serving scheduler and ``LifeService``.

The reference's tests/test_serve.py and the serving half of
tests/test_obs.py, case by case, on the port's service over the CPU:
bucketing, continuous batching, priority and deadline order, fair
slicing, quarantine of a poisoned tenant, kill-and-resume bit for bit,
the counter algebra over random traces.  Then the two services side by
side on the same submissions: bucket keys and completion order equal,
weights within rtol 2e-4 / atol 2e-5, and a checkpoint directory written
by either resumed by the other.  Mesh jobs (solo buckets keyed by their
topology, intake refusals, kill-and-resume) are in test_torch_mesh.py.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core.life import LifeConfig as JConfig
from repro.serve import LifeService as JService
from repro.serve import dataset_key as j_dataset_key
from repro_torch import obs
from repro_torch.bridge import from_reference, to_numpy
from repro_torch.checkpoint import manager as CK
from repro_torch.core.batched import BatchedLifeEngine
from repro_torch.core.life import LifeConfig, LifeEngine
from repro_torch.serve import (BATCHABLE_FORMATS, JobFailedError,
                               LifeService, Scheduler, dataset_key)
from repro_torch.serve.scheduler import Job

TEST_SEED = int(os.environ.get("REPRO_TEST_SEED", "0"))
#: the conformance matrix's fp32 tolerance (tests/test_conformance.py)
FP32_TOL = dict(rtol=2e-4, atol=2e-5)


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


@pytest.fixture(scope="module")
def cohort(tiny_cohort):
    return [_port(p) for p in tiny_cohort]


def _cfg(**kw):
    kw.setdefault("executor", "opt")
    kw.setdefault("n_iters", 12)
    kw.setdefault("plan_cache_dir", "")
    return LifeConfig(**kw)


def _service(cfg=None, **kw):
    return LifeService(_cfg() if cfg is None else cfg, device="cpu", **kw)


def _scheduler(cfg=None, **kw):
    return Scheduler(_cfg() if cfg is None else cfg, device="cpu", **kw)


def _poison(problem):
    """A truncated signal keeps the bucket key (it has no ``b`` part), so
    the poisoned job shares its micro-batch with healthy tenants of the
    same acquisition and fails there."""
    return dataclasses.replace(problem, b=problem.b[:-3])


def _equal(a, b):
    assert torch.equal(a, b), float((a - b).abs().max())


# ----------------------------------------------------------------------------
# scheduler semantics (the reference's tests/test_serve.py)
# ----------------------------------------------------------------------------

def test_batched_bucket_matches_direct_engine(cohort):
    """One bucket served in slices == one BatchedLifeEngine run, exactly."""
    svc = _service(slice_iters=5)
    ids = [svc.submit(p, n_iters=12, format="coo") for p in cohort]
    results = svc.run()
    W, _ = BatchedLifeEngine(cohort, _cfg(), device="cpu").run()
    for i, jid in enumerate(ids):
        w, losses = results[jid]
        _equal(w, W[i])
        assert losses.shape == (12,)


@pytest.mark.parametrize("fmt", ["sell", "fcoo"])
def test_solo_format_jobs_match_their_engine(fmt, problem):
    """SELL and F-COO layouts do not stack: jobs run solo, through the
    kernel-sell / kernel-fcoo executors, and equal their LifeEngine's
    solve bit for bit."""
    svc = _service(slice_iters=5)
    jid = svc.submit(problem, n_iters=12, format=fmt)
    assert svc.scheduler._bucket_key(svc.scheduler.job(jid))[-1] == jid
    w, losses = svc.run()[jid]
    w_ref, l_ref = LifeEngine(problem, _cfg(format=fmt, n_iters=12),
                              device="cpu").run()
    _equal(w, w_ref)
    _equal(losses, l_ref)


def test_continuous_batching_admits_late_arrival(cohort):
    """A job submitted mid-flight joins the bucket's next micro-batch; the
    in-flight job keeps its iteration parity across the re-stack, and
    both equal their uninterrupted counterparts."""
    svc = _service(slice_iters=4)
    first = svc.submit(cohort[0], n_iters=12, format="coo")
    svc.step()                                      # first runs 4 iters alone
    assert svc.scheduler.job(first).state.it == 4
    late = svc.submit(cohort[1], n_iters=12, format="coo")
    svc.step()                                      # re-stacked: 4+4, 0+4
    assert [svc.scheduler.job(j).state.it for j in (first, late)] == [8, 4]
    results = svc.run()
    assert set(results) == {first, late}
    for jid, prob in ((first, cohort[0]), (late, cohort[1])):
        w_ref, l_ref = LifeEngine(prob, _cfg(n_iters=12), device="cpu").run()
        w, losses = results[jid]
        torch.testing.assert_close(w, w_ref, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(losses, l_ref, rtol=1e-3, atol=0.0)


def test_priority_orders_buckets(cohort):
    sched = _scheduler(slice_iters=100)             # one slice finishes a job
    sched.submit(Job(job_id="lo", problem=cohort[0], n_iters=8, priority=0,
                     format="coo"))
    sched.submit(Job(job_id="hi", problem=cohort[1], n_iters=8, priority=5,
                     format="sell"))
    assert [j.job_id for j in sched.tick()] == ["hi"]


def test_deadline_beats_priority(cohort):
    sched = _scheduler(slice_iters=100)
    sched.submit(Job(job_id="pri", problem=cohort[0], n_iters=8,
                     priority=9, format="coo"))
    sched.submit(Job(job_id="ddl", problem=cohort[1], n_iters=8,
                     priority=0, deadline=1.0, format="sell"))
    assert [j.job_id for j in sched.tick()] == ["ddl"]


def test_fair_time_slicing(cohort):
    sched = _scheduler(slice_iters=4)
    sched.submit(Job(job_id="a", problem=cohort[0], n_iters=8,
                     format="coo"))
    sched.submit(Job(job_id="b", problem=cohort[1], n_iters=8,
                     format="sell"))
    sched.tick()
    a, b = sched.job("a"), sched.job("b")
    assert {a.done, b.done} == {4, 0}
    sched.tick()
    assert (a.done, b.done) == (4, 4)               # the other bucket ran


def test_rejects_unknown_format_and_duplicate_ids(problem):
    sched = _scheduler()
    with pytest.raises(ValueError, match="format"):
        sched.submit(Job(job_id="x", problem=problem, n_iters=4,
                         format="csr"))
    sched.submit(Job(job_id="x", problem=problem, n_iters=4, format="coo"))
    with pytest.raises(ValueError, match="already"):
        sched.submit(Job(job_id="x", problem=problem, n_iters=4,
                         format="coo"))
    with pytest.raises(ValueError, match="/"):
        sched.submit(Job(job_id="a/b", problem=problem, n_iters=4,
                         format="coo"))


def test_batchable_formats_constant():
    assert set(BATCHABLE_FORMATS) == {"auto", "coo", "alto"}


def test_rejects_compaction_config():
    with pytest.raises(ValueError, match="compact"):
        _scheduler(_cfg(compact_every=10))


@pytest.mark.parametrize("mesh", [(1, 1), (2, 2)])
def test_mesh_jobs_name_the_mesh_slice(mesh, problem):
    """A mesh job's solo bucket is keyed by its mesh slice, and its engine
    runs the format's mesh executor over that slice."""
    svc = _service(slice_iters=2)
    jid = svc.submit(problem, n_iters=4, format="coo", mesh=mesh)
    svc.step()
    (key, bucket), = svc.scheduler._buckets.items()
    assert key[5] == mesh and key[-1] == jid and bucket.solo
    executor = bucket._engine.executor
    assert executor.name == "shard" and executor.plans["mesh"].shape == mesh
    assert svc.run()[jid][1].shape == (4,)


def test_no_card_and_no_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        LifeService(_cfg())


# ----------------------------------------------------------------------------
# failure isolation: one bad tenant fails alone
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["coo", "sell", "fcoo"])
def test_poisoned_tenant_fails_alone(fmt, cohort):
    svc = _service(slice_iters=5)
    svc.submit(cohort[0], job_id="good", n_iters=10, format=fmt)
    svc.submit(_poison(cohort[0]), job_id="bad", n_iters=10, format=fmt)
    svc.submit(cohort[1], job_id="other", n_iters=10, format="coo")
    results = svc.run()
    assert set(results) == {"good", "other"}
    for jid in ("good", "other"):
        assert results[jid][1].shape == (10,)
    assert svc.status("bad") == "failed"
    assert svc.failed_jobs == ("bad",)
    err = svc.error("bad")
    assert isinstance(err, Exception)
    with pytest.raises(JobFailedError) as ei:
        svc.result("bad")
    assert ei.value.error is err and ei.value.__cause__ is err


def test_quarantine_preserves_survivor_trajectory(cohort):
    svc = _service(slice_iters=5)
    svc.submit(cohort[0], job_id="good", n_iters=12, format="coo")
    svc.submit(_poison(cohort[1]), job_id="bad", n_iters=12, format="coo")
    w, losses = svc.run()["good"]
    W, _ = BatchedLifeEngine([cohort[0]], _cfg(), device="cpu").run()
    _equal(w, W[0])
    assert losses.shape == (12,)
    assert svc.failed_jobs == ("bad",)


def test_transient_batch_failure_keeps_survivors(cohort, monkeypatch):
    svc = _service(slice_iters=4)
    a = svc.submit(cohort[0], n_iters=8, format="coo")
    b = svc.submit(cohort[1], n_iters=8, format="coo")
    orig = BatchedLifeEngine.step
    tripped = []

    def flaky(self, states, k):
        if states.w.shape[0] > 1 and not tripped:
            tripped.append(True)
            raise RuntimeError("injected transient fault")
        return orig(self, states, k)

    monkeypatch.setattr(BatchedLifeEngine, "step", flaky)
    results = svc.run()
    assert tripped and set(results) == {a, b}
    assert svc.failed_jobs == ()
    for jid in (a, b):
        assert results[jid][1].shape == (8,)


def test_resume_bit_identical_with_poisoned_batchmate(cohort, tmp_path):
    cfg = _cfg(n_iters=24)
    ref = _service(cfg, slice_iters=5)
    ref.submit(cohort[0], job_id="good", n_iters=24, format="coo")
    ref.submit(_poison(cohort[1]), job_id="bad", n_iters=24, format="coo")
    w_ref, l_ref = ref.run()["good"]

    ck = str(tmp_path / "svc")
    svc = _service(cfg, ckpt_dir=ck, checkpoint_every=1, slice_iters=5)
    svc.submit(cohort[0], job_id="good", n_iters=24, format="coo")
    svc.submit(_poison(cohort[1]), job_id="bad", n_iters=24, format="coo")
    svc.step()
    svc.step()
    del svc                                         # the "kill"

    svc2 = _service(cfg, ckpt_dir=ck, checkpoint_every=1, slice_iters=5)
    assert "good" in svc2.resumable_jobs
    svc2.submit(cohort[0], job_id="good")
    w_res, l_res = svc2.run()["good"]
    _equal(w_res, w_ref)
    _equal(l_res, l_ref)
    _, _, manifest = CK.restore(ck)
    assert "error" in manifest["jobs"]["bad"]


def test_submitted_at_zero_boundary(problem):
    sched = _scheduler()
    j = sched.submit(Job(job_id="z", problem=problem, n_iters=4,
                         format="coo", submitted_at=0.0))
    assert j.submitted_at == 0.0
    j2 = sched.submit(Job(job_id="u", problem=problem, n_iters=4,
                          format="coo"))
    assert j2.submitted_at is not None and j2.submitted_at > 0.0


def test_latency_spans_service_incarnations(problem, tmp_path):
    ck = str(tmp_path / "svc")
    svc = _service(_cfg(n_iters=24), ckpt_dir=ck, checkpoint_every=1,
                   slice_iters=5)
    svc.submit(problem, job_id="t", n_iters=24, format="coo")
    svc.step()
    svc.step()
    del svc
    _, _, manifest = CK.restore(ck)
    elapsed0 = manifest["jobs"]["t"]["elapsed"]
    assert elapsed0 > 0.0

    obs.enable()
    svc2 = _service(_cfg(n_iters=24), ckpt_dir=ck, checkpoint_every=1,
                    slice_iters=5)
    svc2.submit(problem, job_id="t")
    job = svc2.scheduler.job("t")
    assert job.prior_elapsed == pytest.approx(elapsed0)
    job.prior_elapsed = 100.0       # make the restored leg unmistakable
    svc2.run()
    h = obs.histogram("serve.job.latency.seconds")
    assert h.count == 1 and h.min >= 100.0
    _, _, m2 = CK.restore(ck)
    assert m2["jobs"]["t"]["elapsed"] >= 100.0


# ----------------------------------------------------------------------------
# resume after a kill: identical weights, coo + sell + fcoo
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["coo", "sell", "fcoo"])
def test_interrupted_then_resumed_matches_uninterrupted(fmt, problem,
                                                        tmp_path):
    cfg = _cfg(n_iters=24)
    ref = _service(cfg, slice_iters=5)
    jid = ref.submit(problem, job_id="tenant", n_iters=24, format=fmt)
    w_ref, l_ref = ref.run()[jid]

    ck = str(tmp_path / "svc")
    svc = _service(cfg, ckpt_dir=ck, checkpoint_every=1, slice_iters=5)
    svc.submit(problem, job_id="tenant", n_iters=24, format=fmt)
    svc.step()
    svc.step()                                      # 10 of 24 iters, then die
    assert svc.scheduler.job("tenant").done == 10
    del svc

    svc2 = _service(cfg, ckpt_dir=ck, checkpoint_every=1, slice_iters=5)
    assert svc2.resumable_jobs == ("tenant",)
    svc2.submit(problem, job_id="tenant", format=fmt)
    job = svc2.scheduler.job("tenant")
    assert job.done == 10 and job.state.it == 10    # adopted mid-flight
    w_res, l_res = svc2.run()["tenant"]
    _equal(w_res, w_ref)
    _equal(l_res, l_ref)
    assert l_res.shape == (24,)


def test_resume_rejects_different_data(problem, cohort, tmp_path):
    ck = str(tmp_path / "svc")
    svc = _service(ckpt_dir=ck, checkpoint_every=1, slice_iters=4)
    svc.submit(problem, job_id="t", n_iters=12, format="coo")
    svc.step()
    del svc
    svc2 = _service(ckpt_dir=ck)
    with pytest.raises(ValueError, match="digest"):
        svc2.submit(cohort[0], job_id="t", format="coo")


def test_completed_job_reserves_instantly_after_restart(problem, tmp_path):
    ck = str(tmp_path / "svc")
    svc = _service(ckpt_dir=ck, checkpoint_every=1, slice_iters=4)
    svc.submit(problem, job_id="t", n_iters=12, format="coo")
    w_ref, l_ref = svc.run()["t"]
    del svc
    svc2 = _service(ckpt_dir=ck)
    assert svc2.resumable_jobs == ("t",)
    svc2.submit(problem, job_id="t", format="coo")
    assert svc2.scheduler.job("t").remaining == 0   # nothing left to run
    w, losses = svc2.run()["t"]
    _equal(w, w_ref)
    _equal(losses, l_ref)


def test_resume_honors_explicit_overrides(problem, tmp_path):
    ck = str(tmp_path / "svc")
    svc = _service(ckpt_dir=ck, checkpoint_every=1, slice_iters=4)
    svc.submit(problem, job_id="t", n_iters=12, priority=3, format="coo")
    svc.step()
    del svc
    svc2 = _service(ckpt_dir=ck, checkpoint_every=1, slice_iters=4)
    with pytest.raises(ValueError, match="format"):
        svc2.submit(problem, job_id="t", format="sell")
    with pytest.raises(ValueError, match="w0"):
        svc2.submit(problem, job_id="t",
                    w0=np.ones(problem.phi.n_fibers, np.float32))
    svc2.submit(problem, job_id="t", n_iters=20)    # extend 12 -> 20
    job = svc2.scheduler.job("t")
    assert (job.n_iters, job.done) == (20, 4)
    assert job.priority == 3 and job.format == "coo"   # restored
    _, losses = svc2.run()["t"]
    assert losses.shape == (20,)


def test_checkpoint_roundtrip_includes_loss_history(problem, tmp_path):
    ck = str(tmp_path / "svc")
    svc = _service(ckpt_dir=ck, checkpoint_every=1, slice_iters=6)
    svc.submit(problem, job_id="t", n_iters=18, format="coo")
    svc.step()
    del svc
    svc2 = _service(ckpt_dir=ck, checkpoint_every=1, slice_iters=6)
    svc2.submit(problem, job_id="t", format="coo")
    _, losses = svc2.run()["t"]
    assert losses.shape == (18,)


def test_failed_resume_submit_keeps_state_recoverable(problem, tmp_path):
    """A restored job the scheduler refuses (its checkpoint names a mesh
    slice this host cannot place) stays re-adoptable, and later
    checkpoints carry it along."""
    ck = str(tmp_path / "svc")
    svc = _service(_cfg(n_iters=24), ckpt_dir=ck, checkpoint_every=1,
                   slice_iters=5)
    svc.submit(problem, job_id="tenant", n_iters=24, format="coo")
    svc.step()
    del svc
    step, flat, manifest = CK.restore(ck)
    manifest["jobs"]["tenant"]["mesh"] = [3, 3]     # 9 cells, 8 admitted
    tree = {"tenant": {k.split("/", 1)[1]: v for k, v in flat.items()}}
    CK.save(ck, step, tree, meta={"jobs": manifest["jobs"]})

    svc2 = _service(_cfg(n_iters=24), ckpt_dir=ck, checkpoint_every=1,
                    slice_iters=5)
    assert svc2.resumable_jobs == ("tenant",)
    with pytest.raises(ValueError, match="devices"):
        svc2.submit(problem, job_id="tenant")
    assert svc2.resumable_jobs == ("tenant",)       # state not consumed
    svc2.submit(problem, job_id="other", n_iters=8, format="coo")
    svc2.run()
    del svc2
    svc3 = _service(_cfg(n_iters=24), ckpt_dir=ck)
    assert "tenant" in svc3.resumable_jobs


def test_warm_start_w0_mixes_with_cold_batchmates(cohort):
    """A warm job starts from ``w0`` and shares a micro-batch with a cold
    one: the pair equals the cohort solve started from ``[w0, ones]``."""
    w0 = np.full(cohort[0].phi.n_fibers, 0.5, np.float32)
    svc = _service(slice_iters=5)
    warm = svc.submit(cohort[0], n_iters=10, format="coo", w0=w0)
    cold = svc.submit(cohort[1], n_iters=10, format="coo")
    results = svc.run()
    start = torch.stack([torch.from_numpy(w0), torch.ones(len(w0))])
    W, _ = BatchedLifeEngine(cohort[:2], _cfg(), device="cpu").run(10, start)
    _equal(results[warm][0], W[0])
    _equal(results[cold][0], W[1])
    with pytest.raises(ValueError, match="nonnegative"):
        svc.submit(cohort[2], n_iters=4, format="coo", w0=-w0)


# ----------------------------------------------------------------------------
# the counter algebra (the serving half of tests/test_obs.py)
# ----------------------------------------------------------------------------

def test_scheduler_counters_hold_over_random_traces(cohort):
    """At every observable point of a random submit/tick interleaving:
    admitted == completed + queued + running."""
    obs.enable()
    rng = np.random.default_rng(100 + TEST_SEED)
    for trial in range(3):
        obs.reset()
        svc = _service(_cfg(n_iters=8), slice_iters=3)
        pending = [(p, ["coo", "auto", "sell", "fcoo"][rng.integers(4)],
                    int(rng.integers(0, 3)), int(rng.integers(4, 12)))
                   for p in cohort]

        def check():
            assert obs.value("serve.jobs.admitted") == (
                obs.value("serve.jobs.completed")
                + obs.value("serve.queue.depth")
                + obs.value("serve.jobs.running")), trial

        i = 0
        while pending or svc.scheduler.active():
            if pending and (not svc.scheduler.active()
                            or rng.random() < 0.5):
                p, fmt, pri, n = pending.pop()
                svc.submit(p, job_id=f"t{trial}-j{i}", n_iters=n,
                           format=fmt, priority=pri)
                i += 1
            else:
                svc.step()
            check()
        assert obs.value("serve.jobs.admitted") == len(cohort)
        assert obs.value("serve.jobs.completed") == len(cohort)
        assert obs.histogram("serve.queue.depth").count > 0
        assert obs.histogram("serve.slice.seconds").count > 0


def test_extended_counter_algebra_with_failures_and_cancels(cohort):
    """admitted == completed + failed + cancelled + queued + running, with
    poisoned tenants and a cancellation mid-flight."""
    obs.enable()
    rng = np.random.default_rng(300 + TEST_SEED)
    svc = _service(_cfg(n_iters=8), slice_iters=3)
    pending = [(cohort[0], "h0", 40), (cohort[1], "h1", 6),
               (cohort[2], "h2", 6), (_poison(cohort[0]), "p0", 6),
               (_poison(cohort[1]), "p1", 6)]
    rng.shuffle(pending)

    def check():
        assert obs.value("serve.jobs.admitted") == (
            obs.value("serve.jobs.completed") + obs.value("serve.jobs.failed")
            + obs.value("serve.jobs.cancelled")
            + obs.value("serve.queue.depth")
            + obs.value("serve.jobs.running"))

    submitted = set()
    cancelled_h0 = tried_cancel = False
    steps = 0
    while pending or svc.scheduler.active():
        if pending and (not svc.scheduler.active() or rng.random() < 0.5):
            p, jid, n = pending.pop()
            svc.submit(p, job_id=jid, n_iters=n, format="coo")
            submitted.add(jid)
        else:
            svc.step()
            steps += 1
            if not tried_cancel and steps >= 3 and "h0" in submitted:
                tried_cancel = True
                cancelled_h0 = svc.cancel("h0")
                check()
        check()
    assert obs.value("serve.jobs.admitted") == 5.0
    assert obs.value("serve.jobs.failed") == 2.0
    assert obs.value("serve.jobs.cancelled") == float(cancelled_h0)
    assert svc.failed_jobs == ("p0", "p1")


def test_service_latency_and_snapshot_surface(cohort):
    obs.enable()
    svc = _service(_cfg(n_iters=6), slice_iters=3)
    for i, p in enumerate(cohort):
        svc.submit(p, job_id=f"j{i}", n_iters=6, format="coo")
    svc.run()
    lat = obs.histogram("serve.job.latency.seconds")
    assert lat.count == len(cohort) and lat.min >= 0.0
    snap = svc.metrics_snapshot()
    assert obs.snapshot_value(snap, "gauges", "plan_cache.hit_rate") \
        is not None
    assert snap["spans"]["recorded"] > 0
    ticks = [t for t in obs.TRACER.export() if t["name"] == "scheduler.tick"]
    assert ticks and all(t["children"][0]["name"] == "scheduler.slice"
                         for t in ticks)
    # a slice builds its bucket's engine (once) and steps it
    kids = [c for t in ticks for c in t["children"][0]["children"]]
    assert {c["name"] for c in kids} == {"engine.build", "engine.step"}
    steps = [c for c in kids if c["name"] == "engine.step"]
    assert steps
    assert {c["attrs"]["batched"] for c in steps} <= {1, 2, 3}


def test_bucket_rebuild_hits_the_plan_cache(cohort, tmp_path):
    """A cohort bucket rebuilt because its member set changed (a late
    arrival) takes its format plan, keyed by its first member's dataset,
    from the shared plan cache."""
    obs.enable()
    svc = _service(_cfg(plan_cache_dir=str(tmp_path / "plans")),
                   slice_iters=4)
    svc.submit(cohort[0], job_id="a", n_iters=12, format="auto")
    svc.step()
    svc.submit(cohort[1], job_id="b", n_iters=12, format="auto")
    svc.step()
    assert obs.value("plan_cache.lookups", kind="format",
                     outcome="miss") == 1.0
    assert obs.value("plan_cache.lookups", kind="format",
                     outcome="hit") == 1.0
    svc.run()
    # once "a" finishes the bucket is rebuilt over "b" alone, whose own
    # dataset keys the plan: a second miss, as in the reference
    assert (svc.cache_stats.misses, svc.cache_stats.hits) == (2, 1)


# ----------------------------------------------------------------------------
# the two services side by side
# ----------------------------------------------------------------------------

_TRACE = (("a", 0, "auto", 0, 12), ("b", 1, "sell", 2, 8),
          ("c", 2, "auto", 0, 12), ("d", 0, "fcoo", 1, 10),
          ("e", 1, "coo", 0, 6))


def _drive(svc, problems):
    """Submit the trace (``c`` arrives after the first tick); returns the
    bucket key of each job and the order jobs completed in."""
    keys, order = {}, []
    for i, (jid, s, fmt, pri, n) in enumerate(_TRACE):
        if jid == "c":
            order += [j.job_id for j in svc.step()]
        svc.submit(problems[s], job_id=jid, format=fmt, priority=pri,
                   n_iters=n)
        keys[jid] = svc.scheduler._bucket_key(svc.scheduler.job(jid))
    while svc.scheduler.active():
        order += [j.job_id for j in svc.step()]
    return keys, order


def test_buckets_order_and_weights_equal_the_references(tiny_cohort,
                                                        cohort):
    jcfg = JConfig(executor="opt", n_iters=12, plan_cache_dir="")
    jsvc = JService(jcfg, slice_iters=4)
    jkeys, jorder = _drive(jsvc, tiny_cohort)
    svc = _service(slice_iters=4)
    keys, order = _drive(svc, cohort)
    assert order == jorder
    assert keys == jkeys
    for jid, *_ in _TRACE:
        w, losses = svc.result(jid)
        jw, jl = jsvc.result(jid)
        np.testing.assert_allclose(to_numpy(w), np.asarray(jw), **FP32_TOL)
        np.testing.assert_allclose(to_numpy(losses), np.asarray(jl),
                                   rtol=1e-4)


def test_dataset_key_is_the_references(tiny_problem, problem, cohort):
    assert dataset_key(problem) == j_dataset_key(tiny_problem)
    assert dataset_key(problem) == dataset_key(_port(tiny_problem))
    assert dataset_key(problem) != dataset_key(cohort[0])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_between_the_services(writer, tiny_cohort, cohort,
                                                tmp_path):
    """A service checkpoint written by one package is resumed by the
    other: digests match, states adopt mid-flight, and the finished
    weights stay within the conformance tolerance of an uninterrupted
    run of the writing package."""
    ck = str(tmp_path / "svc")
    jcfg = JConfig(executor="opt", n_iters=16, plan_cache_dir="")
    subs = (("s0", 0, "coo"), ("s1", 1, "coo"), ("f2", 2, "sell"))

    def submit_all(svc, problems, **kw):
        for jid, s, fmt in subs:
            svc.submit(problems[s], job_id=jid, format=fmt, **kw)

    sides = {"reference": (lambda **kw: JService(jcfg, slice_iters=5, **kw),
                           tiny_cohort),
             "port": (lambda **kw: _service(_cfg(n_iters=16), slice_iters=5,
                                            **kw), cohort)}
    make, problems = sides[writer]
    read, readers_problems = sides["port" if writer == "reference"
                                   else "reference"]
    first = make(ckpt_dir=ck, checkpoint_every=1)
    submit_all(first, problems, n_iters=16)
    whole = make()
    submit_all(whole, problems, n_iters=16)
    for _ in range(2):
        first.step()
    done = {j.job_id: j.done for j in first.scheduler.jobs()}
    want = whole.run()
    del first
    reader = read(ckpt_dir=ck)
    assert reader.resumable_jobs == ("f2", "s0", "s1")
    for jid, s, _ in subs:
        reader.submit(readers_problems[s], job_id=jid)
        assert reader.scheduler.job(jid).done == done[jid]
    got = reader.run()
    for jid, *_ in subs:
        (w, losses), (w_want, l_want) = got[jid], want[jid]
        assert _np(losses).shape == (16,)
        np.testing.assert_allclose(_np(w), _np(w_want), **FP32_TOL)
        np.testing.assert_allclose(_np(losses), _np(l_want), rtol=1e-4)


def _np(x) -> np.ndarray:
    """A port tensor or a reference array as numpy."""
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
