"""Serve a multi-subject cohort through the batched LiFE engine (torch
counterpart of ``examples/serve_subjects.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_subjects [n_subjects]

The production-scale deployment story: many subjects arrive sharing one
acquisition protocol (same gradient scheme -> same dictionary, same candidate
fiber count).  Instead of running SBBNNLS once per subject, the batched
engine pads every subject's Phi tensor to a common coefficient count and
solves the whole cohort at once, reporting throughput in subjects/sec.  A
persistent plan cache makes re-serving the same dataset (new process, same
data) skip the inspector work entirely.  The warm-up runs cover the
kernels' builds and the plan cache; the timed windows end in a device
synchronisation.
"""
from __future__ import annotations

import tempfile
import time
from typing import Tuple

import numpy as np

from repro_torch.core.batched import BatchedLifeEngine
from repro_torch.core.life import LifeConfig, LifeEngine
from repro_torch.data.dmri import synth_cohort
from repro_torch.device import DeviceLike, fence
from repro_torch.examples import parser, start


def run(n_subjects: int = 4, *, n_fibers: int = 256, n_theta: int = 64,
        n_atoms: int = 64, grid: Tuple[int, int, int] = (14, 14, 14),
        n_iters: int = 60, device: DeviceLike = None) -> dict:
    """Sequential engines against the batched one; returns the batched
    weights ``W`` and ``losses``, the sequential runs ``seq``, both rates
    in subjects/s and each subject's ``prune_stats``."""
    dev = start(device)
    print(f"1. synthesizing {n_subjects}-subject cohort "
          "(shared acquisition, per-subject anatomy)...")
    cohort = synth_cohort(n_subjects, base_seed=0, n_fibers=n_fibers,
                          n_theta=n_theta, n_atoms=n_atoms, grid=grid,
                          device=dev)
    ncs = [p.phi.n_coeffs for p in cohort]
    print(f"   Nc per subject: {ncs} (padded to {max(ncs)})")

    with tempfile.TemporaryDirectory() as plans:
        cfg = LifeConfig(executor="opt", n_iters=n_iters,
                         plan_cache_dir=plans)

        print("2. baseline: sequential per-subject engines...")
        engines = [LifeEngine(p, cfg, device=dev) for p in cohort]
        for e in engines:
            e.run(n_iters=2)                  # warm the builds and caches
        fence(dev)
        t0 = time.perf_counter()
        seq = [e.run() for e in engines]
        fence(dev)
        t_seq = time.perf_counter() - t0
        print(f"   {n_subjects / t_seq:.2f} subjects/sec sequential")

        print("3. batched engine: one SBBNNLS for the whole cohort...")
        beng = BatchedLifeEngine(cohort, cfg, device=dev)
        beng.run(n_iters=2)                   # warm the builds and caches
        fence(dev)
        t0 = time.perf_counter()
        W, losses = beng.run()
        fence(dev)
        t_bat = time.perf_counter() - t0
    print(f"   {n_subjects / t_bat:.2f} subjects/sec batched "
          f"({t_seq / t_bat:.2f}x vs sequential)")

    for s, (w_seq, _) in enumerate(seq):
        np.testing.assert_allclose(W[s].cpu().numpy(), w_seq.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)
    print("   batched weights match the per-subject runs")

    print("4. per-subject pruning results:")
    stats = beng.prune_stats(W)
    final = losses[:, -1].cpu().numpy()
    for s, st in enumerate(stats):
        print(f"   subject {s}: kept {int(st['kept'])}/"
              f"{int(st['total'])} fibers | precision "
              f"{st['precision']:.2f} recall {st['recall']:.2f} "
              f"| final loss {final[s]:.5f}")
    return dict(W=W, losses=losses, seq=seq, stats=stats,
                subjects_per_s=dict(sequential=n_subjects / t_seq,
                                    batched=n_subjects / t_bat))


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("n_subjects", nargs="?", type=int, default=4)
    args = ap.parse_args(argv)
    return run(args.n_subjects, device=args.device)


if __name__ == "__main__":
    main()
