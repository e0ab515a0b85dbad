"""Connectome pruning end to end: solve, prune, virtual-lesion (torch
counterpart of ``examples/prune_connectome.py``).

    PYTHONPATH=src python -m repro_torch.examples.prune_connectome [n_fibers]

The science story the stack exists for (DESIGN.md §15):

  1. solve one subject to convergence (iteration count decided by the
     loss, not a fixed budget),
  2. prune: extract the surviving support and compact Phi onto it,
  3. cross-validate: held-out RMSE over disjoint voxel folds vs the
     null model,
  4. virtual-lesion a spatially coherent bundle: re-solve warm-started
     from the converged weights (lesioned entries zeroed) and print the
     evidence table; the warm re-solve takes a fraction of the cold
     iteration count.
"""
from __future__ import annotations

import tempfile
from typing import Tuple

import numpy as np

from repro_torch.core.life import LifeConfig, LifeEngine
from repro_torch.data.dmri import fiber_bundles, synth_connectome
from repro_torch.device import DeviceLike
from repro_torch.examples import parser, start
from repro_torch.science import (crossval_rmse, prune_connectome,
                                 solve_to_convergence, virtual_lesion,
                                 weight_summary)

#: iterations per convergence check
CHUNK = 8


def run(n_fibers: int = 192, *, n_theta: int = 32, n_atoms: int = 48,
        grid: Tuple[int, int, int] = (12, 12, 12),
        device: DeviceLike = None) -> dict:
    """The science story; returns the converged ``solve``, the ``pruned``
    connectome, the weight ``summary``, the crossval result ``cv``, the
    lesion ``report`` and the ``bundle``."""
    dev = start(device)
    print(f"1. synthesizing a {n_fibers}-fiber candidate connectome...")
    problem = synth_connectome(n_fibers=n_fibers, n_theta=n_theta,
                               n_atoms=n_atoms, grid=grid, seed=7,
                               noise=0.02, device=dev)
    with tempfile.TemporaryDirectory() as plans:
        cfg = LifeConfig(executor="opt", plan_cache_dir=plans)

        print("2. solving to convergence...")
        solve = solve_to_convergence(LifeEngine(problem, cfg, device=dev),
                                     rtol=1e-5, chunk=CHUNK, max_iters=400)
        print(f"   {solve.iters} iterations, final loss "
              f"{solve.losses[-1]:.5f} (converged={solve.converged})")

        print("3. pruning...")
        pruned = prune_connectome(problem, solve.w, threshold=1e-3)
        print(f"   {pruned.describe()}")
        s = weight_summary(solve.w, threshold=1e-3)
        print(f"   surviving weights: min {s['w_min']:.4f} / median "
              f"{s['w_median']:.4f} / max {s['w_max']:.4f}")

        print("4. 3-fold cross-validated RMSE...")
        cv = crossval_rmse(problem, cfg, k=3, n_iters=40, device=dev)
        print(f"   {cv.describe()}")

        print("5. virtual lesion with warm-started re-solve...")
        bundle = fiber_bundles(problem, bundle_size=8, seed=1)[0]
        report = virtual_lesion(problem, bundle, cfg, w_full=solve.w,
                                rtol=1e-5, chunk=CHUNK, max_iters=400,
                                device=dev)
    for line in report.describe().splitlines():
        print(f"   {line}")
    assert np.all(report.w_lesioned[bundle] == 0.0)
    print(f"   warm re-solve used {report.iters_warm} iterations vs "
          f"{solve.iters} for the cold full solve")

    print("done.")
    return dict(solve=solve, pruned=pruned, summary=s, cv=cv,
                report=report, bundle=bundle)


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("n_fibers", nargs="?", type=int, default=192)
    args = ap.parse_args(argv)
    return run(args.n_fibers, device=args.device)


if __name__ == "__main__":
    main()
