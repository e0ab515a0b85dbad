"""Async serving front line: handles, streamed progress, failure isolation
(torch counterpart of ``examples/serve_async.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_async [n_subjects]

Walks the front-line story (DESIGN.md §13) on top of the multi-tenant
service of ``repro_torch.examples.serve_life``:

  1. ``submit_async`` returns a :class:`JobHandle` immediately; the
     frontend's background driver thread owns the tick loop and
     micro-batches compatible tenants while the producer keeps submitting,
  2. one handle's per-slice progress events are streamed live,
  3. a poisoned tenant (truncated signal vector) is submitted alongside
     healthy ones: quarantine bisection fails it alone, every batch-mate
     completes, and the captured exception is read off the handle,
  4. a deliberately tiny admission queue shows backpressure: with
     ``backpressure="shed"`` the lowest-priority pending job is evicted
     and its handle resolves as ``shed``.

The counters printed are ``repro_torch.obs``'s, counted over this run.
"""
from __future__ import annotations

import dataclasses
import tempfile
from typing import Tuple

from repro_torch import obs
from repro_torch.core.life import LifeConfig
from repro_torch.data.dmri import synth_cohort
from repro_torch.device import DeviceLike
from repro_torch.examples import parser, start
from repro_torch.serve import JobFailedError, LifeFrontend

N_ITERS = 40
#: seconds a handle is waited for
WAIT_S = 600.0
COUNTERS = ("admitted", "completed", "failed")


def _counters() -> dict:
    return {k: obs.value(f"serve.jobs.{k}") for k in COUNTERS}


def run(n_subjects: int = 4, *, n_fibers: int = 256, n_theta: int = 64,
        n_atoms: int = 64, grid: Tuple[int, int, int] = (14, 14, 14),
        n_iters: int = N_ITERS, device: DeviceLike = None) -> dict:
    """The front line's story; returns every handle's final ``statuses``
    (tenants, ``poisoned``, ``lo``, ``hi``), the ``counters`` this run
    added, the healthy tenants' ``results`` and the ``poisoned`` job's
    captured error."""
    dev = start(device)
    obs.enable()
    before = _counters()
    print(f"1. synthesizing {n_subjects}-subject cohort...")
    cohort = synth_cohort(n_subjects, base_seed=0, n_fibers=n_fibers,
                          n_theta=n_theta, n_atoms=n_atoms, grid=grid,
                          device=dev)
    statuses, results = {}, {}
    with tempfile.TemporaryDirectory() as plans:
        cfg = LifeConfig(executor="opt", n_iters=n_iters,
                         plan_cache_dir=plans)

        print("2. async submission: handles come back before any solve "
              "runs...")
        with LifeFrontend(cfg, slice_iters=10, max_queue=16,
                          device=dev) as fe:
            handles = {}
            for i, p in enumerate(cohort):
                handles[f"tenant-{i}"] = fe.submit_async(
                    p, job_id=f"tenant-{i}", n_iters=n_iters,
                    priority=5 if i == 1 else 0)
            # a tenant with a truncated signal vector can never solve: the
            # batch build fails, quarantine bisection probes each member
            # solo, and only this one is condemned (DESIGN.md §13.3)
            bad_problem = dataclasses.replace(cohort[0], b=cohort[0].b[:-3])
            bad = fe.submit_async(bad_problem, job_id="poisoned",
                                  n_iters=n_iters)

            print("3. streaming tenant-0's per-slice progress...")
            for ev in handles["tenant-0"].events(timeout=WAIT_S):
                if ev["type"] == "progress":
                    print(f"   tenant-0: {ev['done']}/{ev['n_iters']} iters, "
                          f"loss {ev['loss']:.5f}")
                else:
                    print(f"   tenant-0: terminal event {ev['type']!r}")

            print("4. collecting results: healthy tenants all complete...")
            for jid, h in sorted(handles.items()):
                w, losses = h.result(timeout=WAIT_S)
                results[jid] = (w, losses)
                statuses[jid] = h.status()
                print(f"   {jid}: status {h.status()!r}, "
                      f"final loss {float(losses[-1]):.5f}, "
                      f"{int((w > 1e-6).sum())} fibers kept")

            err = bad.exception(timeout=WAIT_S)
            assert isinstance(err, JobFailedError)
            statuses["poisoned"] = bad.status()
            print(f"   poisoned: status {bad.status()!r}: "
                  f"{type(err.error).__name__} captured on the handle, "
                  f"nobody else was harmed")

        counters = {k: v - before[k] for k, v in _counters().items()}
        print(f"   counters: admitted={counters['admitted']:g} "
              f"completed={counters['completed']:g} "
              f"failed={counters['failed']:g}")

        print("5. backpressure='shed' on a one-slot queue...")
        with LifeFrontend(cfg, slice_iters=10, max_queue=1,
                          backpressure="shed", start=False,
                          device=dev) as fe:
            lo = fe.submit_async(cohort[0], job_id="lo", n_iters=4,
                                 priority=0)
            hi = fe.submit_async(cohort[1], job_id="hi", n_iters=4,
                                 priority=5)
            fe.start()
            hi.result(timeout=WAIT_S)
            statuses.update(lo=lo.status(), hi=hi.status())
            print(f"   lo: status {lo.status()!r} (evicted by the higher-"
                  f"priority arrival); hi: status {hi.status()!r}")

    print("done.")
    return dict(statuses=statuses, counters=counters, results=results,
                poisoned=err)


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("n_subjects", nargs="?", type=int, default=4)
    args = ap.parse_args(argv)
    return run(args.n_subjects, device=args.device)


if __name__ == "__main__":
    main()
