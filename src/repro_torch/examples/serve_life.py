"""Serve LiFE solves as a multi-tenant service, with a kill-and-resume demo
(torch counterpart of ``examples/serve_life.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_life [n_subjects]

Walks the whole serving story (DESIGN.md §8):

  1. jobs with different priorities, deadlines and formats are submitted
     continuously; the scheduler buckets batch-compatible subjects into one
     batched solve and time-slices between buckets,
  2. every few ticks the service checkpoints all in-flight solver states,
  3. the service is "killed" mid-solve and a fresh instance resumes every
     job from the checkpoint, finishing with weights identical to an
     uninterrupted run.

The last tenant asks for ``format="sell"``, which runs on the
``kernel-sell`` executor: on the card, kernels B3 and B4.
"""
from __future__ import annotations

import tempfile
from typing import Tuple

from repro_torch.core.life import LifeConfig
from repro_torch.data.dmri import synth_cohort
from repro_torch.device import DeviceLike
from repro_torch.examples import parser, start
from repro_torch.serve import LifeService

N_ITERS = 60


def _submit_all(svc: LifeService, cohort, n_iters: int) -> None:
    n = len(cohort)
    for i, p in enumerate(cohort):
        # tenant 0 is latency-sensitive (deadline), tenant 1 is high
        # priority, the last tenant wants the SELL fast path
        svc.submit(p, job_id=f"tenant-{i}", n_iters=n_iters,
                   priority=5 if i == 1 else 0,
                   deadline=2.0 if i == 0 else None,
                   format="sell" if i == n - 1 else "coo")


def run(n_subjects: int = 4, *, n_fibers: int = 256, n_theta: int = 64,
        n_atoms: int = 64, grid: Tuple[int, int, int] = (14, 14, 14),
        n_iters: int = N_ITERS, device: DeviceLike = None) -> dict:
    """The uninterrupted service, then the killed and resumed one; returns
    both runs' results by job id (``reference``, ``resumed``: (w, losses)
    on the device), the progress at the kill, each job's ``max_dw`` and
    the ``cohort``."""
    dev = start(device)
    print(f"1. synthesizing {n_subjects}-subject cohort...")
    cohort = synth_cohort(n_subjects, base_seed=0, n_fibers=n_fibers,
                          n_theta=n_theta, n_atoms=n_atoms, grid=grid,
                          device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = LifeConfig(executor="opt", n_iters=n_iters,
                         plan_cache_dir=f"{tmp}/plans")

        print("2. uninterrupted service run (reference)...")
        ref = LifeService(cfg, slice_iters=10, device=dev)
        _submit_all(ref, cohort, n_iters)
        ref_results = ref.run()
        for jid in sorted(ref_results):
            w, losses = ref_results[jid]
            print(f"   {jid}: final loss {float(losses[-1]):.5f}, "
                  f"{int((w > 1e-6).sum())} fibers kept")

        print("3. same jobs, but the service dies mid-solve...")
        ckpt_dir = f"{tmp}/ckpt"
        svc = LifeService(cfg, ckpt_dir=ckpt_dir, checkpoint_every=1,
                          slice_iters=10, device=dev)
        _submit_all(svc, cohort, n_iters)
        for _ in range(3):
            svc.step()                   # a few time slices, checkpointed
        done = {j.job_id: j.done for j in svc.scheduler.jobs()}
        print(f"   progress at kill: {done}")
        del svc                          # the crash

        print("4. new service instance resumes from the checkpoint...")
        svc2 = LifeService(cfg, ckpt_dir=ckpt_dir, checkpoint_every=1,
                           slice_iters=10, device=dev)
        print(f"   resumable jobs: {list(svc2.resumable_jobs)}")
        for i, p in enumerate(cohort):   # clients resubmit their data
            svc2.submit(p, job_id=f"tenant-{i}",
                        format="sell" if i == n_subjects - 1 else "coo")
        results = svc2.run()

    print("5. resumed weights vs uninterrupted run:")
    max_dw = {}
    for jid in sorted(results):
        w_res, _ = results[jid]
        w_ref, _ = ref_results[jid]
        err = float((w_res - w_ref).abs().max())
        max_dw[jid] = err
        print(f"   {jid}: max |dw| = {err:.2e}")
        assert err <= 1e-6, f"{jid} diverged after resume"
    print("   every tenant resumed bit-compatibly")
    return dict(reference=ref_results, resumed=results, progress=done,
                max_dw=max_dw, cohort=cohort)


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("n_subjects", nargs="?", type=int, default=4)
    args = ap.parse_args(argv)
    return run(args.n_subjects, device=args.device)


if __name__ == "__main__":
    main()
