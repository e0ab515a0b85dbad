"""Port vs reference: the async serving front line (``LifeFrontend``).

The reference's tests/test_frontend.py case by case on the port over the
CPU: ``submit_async`` results equal the port's synchronous
``LifeService`` bit for bit, progress streams through the handle, each
backpressure policy does what it says at the bound, a poisoned tenant and
a saturated admission queue never wedge the healthy jobs, cancellation,
and a ``shutdown(drain=False)`` that a fresh service resumes.  Then the
port's own contract: an exception in the driver thread resolves every
handle it holds as failed and ``shutdown`` re-raises it.  Last, the port's
frontend beside the reference's on the same jobs: weights within the
trajectory tolerance (rtol 2e-2, atol 2e-3).

Every blocking call passes a timeout and every started driver is shut
down inside its test.
"""
import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.life import LifeConfig as JConfig
from repro.serve import LifeFrontend as JFrontend
from repro_torch import obs
from repro_torch.bridge import from_reference
from repro_torch.core.life import LifeConfig
from repro_torch.learn import clear_load_memo, refine
from repro_torch.serve import (BACKPRESSURE_POLICIES, AdmissionQueueFull,
                               JobCancelledError, JobFailedError,
                               LifeFrontend, LifeService, ShutdownError)

TEST_SEED = int(os.environ.get("REPRO_TEST_SEED", "0"))
#: the conformance trajectory bound (tests/test_conformance.py)
TRAJ_TOL = dict(rtol=2e-2, atol=2e-3)
WAIT = 300                      # seconds any blocking call may take


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_state_clean():
    """The port's observability, refine queue and predictor memo start
    empty for every test (tests/conftest.py resets only the
    reference's)."""
    obs.disable()
    obs.reset()
    refine.QUEUE.clear()
    clear_load_memo()
    yield
    obs.disable()
    obs.reset()
    refine.QUEUE.clear()
    clear_load_memo()


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


def _frontend(cfg=None, **kw):
    return LifeFrontend(_cfg() if cfg is None else cfg, device="cpu", **kw)


def _poison(problem):
    """A truncated signal keeps the bucket key (it has no ``b`` part), so
    the job lands in the same micro-batch as healthy tenants of the same
    acquisition and fails there."""
    return dataclasses.replace(problem, b=problem.b[:-3])


# ----------------------------------------------------------------------------
# async results == sync results
# ----------------------------------------------------------------------------

def test_submit_async_matches_sync_service(cohort):
    """The frontend is a transport, not a solver: handles resolve to the
    exact tensors the synchronous service produces for the same batch."""
    ref = LifeService(_cfg(), slice_iters=5, device="cpu")
    ids = [ref.submit(p, n_iters=12, format="coo") for p in cohort]
    expected = ref.run()
    fe = _frontend(slice_iters=5, start=False)
    handles = [fe.submit_async(p, n_iters=12, format="coo") for p in cohort]
    with fe:
        for h, jid in zip(handles, ids):
            w, losses = h.result(timeout=WAIT)
            w_ref, l_ref = expected[jid]
            assert isinstance(w, torch.Tensor) and w.device.type == "cpu"
            assert torch.equal(w, w_ref) and torch.equal(losses, l_ref)
            assert h.done() and h.status() == "done"


@pytest.mark.parametrize("fmt", ["sell", "fcoo", "auto"])
def test_solo_and_auto_jobs_match_sync_service(fmt, problem, tmp_path):
    """Every job format through the frontend equals the same job through
    the service, bit for bit.  One plan cache: "auto"'s measured rung
    decides once, and both read its FormatPlan."""
    cfg = _cfg(plan_cache_dir=str(tmp_path))
    ref = LifeService(cfg, slice_iters=4, device="cpu")
    jid = ref.submit(problem, n_iters=10, format=fmt)
    w_ref, l_ref = ref.run()[jid]
    with _frontend(cfg, slice_iters=4) as fe:
        w, losses = fe.submit_async(problem, n_iters=10,
                                    format=fmt).result(timeout=WAIT)
    assert torch.equal(w, w_ref) and torch.equal(losses, l_ref)


def test_events_stream_per_slice_progress(problem):
    fe = _frontend(slice_iters=4, start=False)
    h = fe.submit_async(problem, n_iters=12, format="coo")
    with fe:
        events = list(h.events(timeout=WAIT))
    assert events[-1] == {"type": "done"}
    progress = events[:-1]
    assert progress and all(e["type"] == "progress" for e in progress)
    done = [e["done"] for e in progress]
    assert done == sorted(done) and done[-1] == 12
    assert all(e["n_iters"] == 12 for e in progress)
    assert all(np.isfinite(e["loss"]) for e in progress)


def test_validation_error_resolves_handle_not_raises(problem):
    """Admission-time validation failures are per-job outcomes."""
    with _frontend(slice_iters=4) as fe:
        good = fe.submit_async(problem, n_iters=4, format="coo")
        bad = fe.submit_async(problem, n_iters=4, format="csr")
        assert isinstance(bad.exception(timeout=WAIT), ValueError)
        assert bad.status() == "rejected"
        with pytest.raises(JobFailedError):
            bad.result(timeout=WAIT)
        w, losses = good.result(timeout=WAIT)
        assert losses.shape == (4,)


# ----------------------------------------------------------------------------
# backpressure policies at the admission bound
# ----------------------------------------------------------------------------

def test_backpressure_reject_raises_at_bound(cohort):
    obs.enable()
    fe = _frontend(slice_iters=8, max_queue=2, backpressure="reject",
                   start=False)
    a = fe.submit_async(cohort[0], n_iters=4, format="coo")
    b = fe.submit_async(cohort[1], n_iters=4, format="coo")
    with pytest.raises(AdmissionQueueFull):
        fe.submit_async(cohort[2], n_iters=4, format="coo")
    assert obs.value("serve.admission.rejected") == 1.0
    assert obs.value("serve.admission.depth") == 2.0
    with fe:
        pass
    assert a.status() == "done" and b.status() == "done"
    assert obs.value("serve.jobs.completed") == 2.0


def test_backpressure_shed_evicts_lowest_priority(cohort):
    obs.enable()
    fe = _frontend(slice_iters=8, max_queue=2, backpressure="shed",
                   start=False)
    lo = fe.submit_async(cohort[0], n_iters=4, priority=0, format="coo")
    mid = fe.submit_async(cohort[1], n_iters=4, priority=3, format="coo")
    hi = fe.submit_async(cohort[2], n_iters=4, priority=5, format="coo")
    assert lo.done() and lo.status() == "shed"
    with pytest.raises(AdmissionQueueFull):
        lo.result(timeout=WAIT)
    newcomer = fe.submit_async(cohort[0], n_iters=4, priority=1,
                               format="coo")
    assert newcomer.status() == "shed"
    assert obs.value("serve.admission.shed") == 2.0
    with fe:
        pass
    assert mid.status() == "done" and hi.status() == "done"


def test_backpressure_block_times_out_without_driver(cohort):
    fe = _frontend(slice_iters=8, max_queue=1, backpressure="block",
                   start=False)
    first = fe.submit_async(cohort[0], n_iters=4, format="coo")
    with pytest.raises(AdmissionQueueFull):
        fe.submit_async(cohort[1], n_iters=4, format="coo", timeout=0.05)
    with fe:
        first.result(timeout=WAIT)


def test_backpressure_block_waits_for_space(cohort):
    with _frontend(slice_iters=8, max_queue=1) as fe:
        handles = [fe.submit_async(p, n_iters=4, format="coo", timeout=WAIT)
                   for p in cohort]
        for h in handles:
            w, losses = h.result(timeout=WAIT)
            assert losses.shape == (4,)


def test_blocked_submitter_released_on_shutdown(cohort):
    fe = _frontend(max_queue=1, backpressure="block", start=False)
    fe.submit_async(cohort[0], n_iters=4, format="coo")
    errs = []

    def blocked():
        try:
            fe.submit_async(cohort[1], n_iters=4, format="coo", timeout=WAIT)
        except Exception as exc:
            errs.append(exc)

    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.05)
    fe.shutdown(timeout=WAIT)
    t.join(30)
    assert not t.is_alive()
    assert len(errs) == 1 and isinstance(errs[0], RuntimeError)


def test_constructor_validation(problem):
    assert BACKPRESSURE_POLICIES == ("block", "reject", "shed")
    with pytest.raises(ValueError, match="backpressure"):
        _frontend(backpressure="drop", start=False)
    with pytest.raises(ValueError, match="max_queue"):
        _frontend(max_queue=0, start=False)
    with pytest.raises(ValueError, match="either"):
        LifeFrontend(_cfg(), service=LifeService(_cfg(), device="cpu"),
                     start=False)


# ----------------------------------------------------------------------------
# cancellation
# ----------------------------------------------------------------------------

def test_cancel_pending_and_running(cohort):
    fe = _frontend(slice_iters=2, start=False)
    running = fe.submit_async(cohort[0], n_iters=200, format="coo")
    pending = fe.submit_async(cohort[1], n_iters=200, format="sell")
    assert pending.cancel()
    assert pending.status() == "cancelled"
    with pytest.raises(JobCancelledError):
        pending.result(timeout=WAIT)
    with fe:
        assert running.cancel()
        with pytest.raises(JobCancelledError):
            running.result(timeout=WAIT)
    assert running.status() == "cancelled"
    assert not running.cancel()


# ----------------------------------------------------------------------------
# a poisoned tenant and a saturated queue
# ----------------------------------------------------------------------------

def test_acceptance_poisoned_tenant_full_queue_no_wedge(cohort):
    """One always-raising tenant and a full admission queue: every healthy
    job completes, the failed job's exception surfaces on its handle, and
    the extended counter algebra holds in the snapshot."""
    from repro_torch.obs import snapshot_value
    obs.enable()
    fe = _frontend(slice_iters=3, max_queue=2, backpressure="block")
    bad = fe.submit_async(_poison(cohort[0]), job_id="bad", n_iters=6,
                          format="coo", timeout=WAIT)
    fmts = ["coo", "sell", "fcoo"]
    healthy = [fe.submit_async(cohort[i % len(cohort)], job_id=f"h{i}",
                               n_iters=6, format=fmts[i % len(fmts)],
                               timeout=WAIT)
               for i in range(6)]
    for h in healthy:
        w, losses = h.result(timeout=WAIT)
        assert losses.shape == (6,) and h.status() == "done"
    err = bad.exception(timeout=WAIT)
    assert isinstance(err, JobFailedError) and err.job_id == "bad"
    assert isinstance(err.error, Exception)
    with pytest.raises(JobFailedError):
        bad.result(timeout=WAIT)
    fe.shutdown(timeout=WAIT)
    snap = fe.service.metrics_snapshot()
    admitted = snapshot_value(snap, "counters", "serve.jobs.admitted")
    completed = snapshot_value(snap, "counters", "serve.jobs.completed")
    failed = snapshot_value(snap, "counters", "serve.jobs.failed")
    cancelled = snapshot_value(snap, "counters", "serve.jobs.cancelled")
    queued = snapshot_value(snap, "gauges", "serve.queue.depth")
    running = snapshot_value(snap, "gauges", "serve.jobs.running")
    assert (admitted, failed) == (7.0, 1.0)
    assert admitted == completed + failed + cancelled + queued + running
    assert snapshot_value(snap, "gauges", "serve.admission.depth") == 0.0


def test_async_stress_randomized_interleavings(cohort):
    """Concurrent producers racing a bounded queue, poisoned tenants mixed
    in: every handle reaches a terminal state, only poisoned jobs fail."""
    obs.enable()
    rng = np.random.default_rng(200 + TEST_SEED)
    specs = []
    for i in range(9):
        poisoned = i in (2, 5)
        p = cohort[int(rng.integers(len(cohort)))]
        specs.append((f"s{i}", _poison(p) if poisoned else p, poisoned,
                      int(rng.integers(3, 9)),
                      ["coo", "auto", "sell"][int(rng.integers(3))],
                      int(rng.integers(0, 3))))
    fe = _frontend(slice_iters=3, max_queue=3, backpressure="block")
    handles = {}

    def producer(chunk):
        for jid, p, _, n, fmt, pri in chunk:
            handles[jid] = fe.submit_async(p, job_id=jid, n_iters=n,
                                           format=fmt, priority=pri,
                                           timeout=WAIT)

    threads = [threading.Thread(target=producer, args=(specs[i::3],))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    for jid, _, poisoned, n, _, _ in specs:
        h = handles[jid]
        if poisoned:
            assert isinstance(h.exception(timeout=WAIT), JobFailedError)
            assert h.status() == "failed"
        else:
            w, losses = h.result(timeout=WAIT)
            assert losses.shape == (n,)
    fe.shutdown(timeout=WAIT)
    admitted = obs.value("serve.jobs.admitted")
    assert (admitted, obs.value("serve.jobs.failed")) == (9.0, 2.0)
    assert admitted == (obs.value("serve.jobs.completed")
                        + obs.value("serve.jobs.failed")
                        + obs.value("serve.jobs.cancelled")
                        + obs.value("serve.queue.depth")
                        + obs.value("serve.jobs.running"))


def test_driver_thread_error_fails_its_handles(cohort):
    """An exception that escapes the driver loop (not one tenant's) stops
    the driver, resolves every handle it holds as failed with that
    exception, refuses later submissions and re-raises at shutdown."""
    fe = _frontend(slice_iters=2, start=False)
    calls = []

    def broken_step():
        calls.append(1)
        raise RuntimeError("card fault")

    fe.service.step = broken_step
    handles = [fe.submit_async(p, n_iters=8, format="coo") for p in cohort]
    fe.start()
    for h in handles:
        err = h.exception(timeout=WAIT)
        assert isinstance(err, RuntimeError) and "card fault" in str(err)
        assert h.status() == "failed"
        with pytest.raises(RuntimeError, match="card fault"):
            h.result(timeout=WAIT)
    assert calls == [1]
    with pytest.raises(RuntimeError, match="driver thread failed"):
        fe.submit_async(cohort[0], n_iters=4)
    with pytest.raises(RuntimeError, match="driver thread failed") as info:
        fe.shutdown(timeout=WAIT)
    assert "card fault" in str(info.value.__cause__)


# ----------------------------------------------------------------------------
# shutdown semantics
# ----------------------------------------------------------------------------

def test_shutdown_without_drain_checkpoints_for_resume(problem, tmp_path):
    """``shutdown(drain=False)`` stops mid-solve but loses nothing:
    waiters get ShutdownError, the final checkpoint lands, and a restarted
    service re-adopts the interrupted job and finishes it bit for bit."""
    ck = str(tmp_path / "svc")
    fe = _frontend(_cfg(n_iters=64), ckpt_dir=ck, checkpoint_every=0,
                   slice_iters=2, start=False)
    orig_step = fe.service.step

    def slow_step():
        time.sleep(0.05)
        return orig_step()

    fe.service.step = slow_step
    h = fe.submit_async(problem, job_id="t", n_iters=64, format="coo")
    fe.start()
    assert next(h.events(timeout=WAIT))["type"] == "progress"
    fe.shutdown(drain=False, timeout=WAIT)
    assert isinstance(h.exception(timeout=WAIT), ShutdownError)
    assert h.status() == "failed"

    svc = LifeService(_cfg(n_iters=64), ckpt_dir=ck, device="cpu")
    assert svc.resumable_jobs == ("t",)
    svc.submit(problem, job_id="t")
    job = svc.scheduler.job("t")
    assert 0 < job.done < 64
    w, losses = svc.run()["t"]
    assert losses.shape == (64,)
    whole = LifeService(_cfg(n_iters=64), slice_iters=2, device="cpu")
    whole.submit(problem, job_id="t", format="coo")
    w_ref, l_ref = whole.run()["t"]
    assert torch.equal(w, w_ref) and torch.equal(losses, l_ref)


# ----------------------------------------------------------------------------
# beside the reference's frontend
# ----------------------------------------------------------------------------

def test_frontend_results_match_reference_frontend(tiny_cohort, cohort):
    """The same jobs through both packages' frontends: each job's weights
    within the trajectory tolerance, the same terminal statuses."""
    jobs = [(0, "coo", 0), (1, "sell", 2), (2, "fcoo", 1), (1, "auto", 0)]
    jfe = JFrontend(JConfig(executor="opt", n_iters=12, plan_cache_dir=""),
                    slice_iters=4, start=False, refine=False)
    fe = _frontend(slice_iters=4, start=False, refine=False)
    jh = [jfe.submit_async(tiny_cohort[s], job_id=f"j{i}", n_iters=12,
                           format=f, priority=p)
          for i, (s, f, p) in enumerate(jobs)]
    ph = [fe.submit_async(cohort[s], job_id=f"j{i}", n_iters=12, format=f,
                          priority=p)
          for i, (s, f, p) in enumerate(jobs)]
    with jfe, fe:
        for a, b in zip(ph, jh):
            w, losses = a.result(timeout=WAIT)
            w_ref, l_ref = b.result(timeout=WAIT)
            assert a.status() == b.status() == "done"
            np.testing.assert_allclose(w.numpy(), np.asarray(w_ref),
                                       **TRAJ_TOL)
            np.testing.assert_allclose(losses.numpy(), np.asarray(l_ref),
                                       rtol=TRAJ_TOL["rtol"])
