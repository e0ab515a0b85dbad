"""Quickstart: prune a synthetic connectome with LiFE (torch counterpart of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks the whole paper pipeline: synthetic dMRI/tractography -> STD encoding
(Phi tensor + dictionary) -> runtime-autotuned restructuring -> SBBNNLS with
weight compaction -> pruned connectome vs ground truth.  The ``auto``
executor times each sort dimension's plain ops on the device and keeps the
fastest, as the reference's does; its plans go to the plan cache
(``$REPRO_PLAN_CACHE`` or ``~/.cache/repro-life``).

``run(problem=...)`` solves a problem that is already built (any size)
instead of synthesizing the quickstart's.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.life import LifeConfig, LifeEngine
from repro_torch.data.dmri import LifeProblem, synth_connectome
from repro_torch.device import DeviceLike
from repro_torch.examples import parser, start


def run(*, n_fibers: int = 512, n_theta: int = 96, n_atoms: int = 96,
        grid: Tuple[int, int, int] = (16, 16, 16), n_iters: int = 100,
        compact_every: int = 25,
        problem: Optional[LifeProblem] = None,
        device: DeviceLike = None) -> dict:
    """The quickstart; returns the weights ``w`` and ``losses`` (on the
    device), the plans' descriptions, the inspector's seconds and
    ``prune_stats``."""
    dev = start(device)
    if problem is None:
        print("1. synthesizing connectome (PROB tractography, "
              f"{n_fibers} fibers)...")
        problem = synth_connectome(n_fibers=n_fibers, n_theta=n_theta,
                                   n_atoms=n_atoms, grid=grid,
                                   algorithm="PROB", seed=0, device=dev)
    else:
        print(f"1. given connectome ({problem.phi.n_fibers} fibers, "
              f"{problem.phi.n_voxels} voxels)...")
    print(f"   Phi: {problem.phi.n_coeffs} coefficients, "
          f"{problem.stats['phi_mbytes']:.1f} MB, "
          f"{problem.stats['nnz_per_fiber']:.1f} nnz/fiber")

    print("2. building engine (runtime-autotuned restructuring)...")
    eng = LifeEngine(problem, LifeConfig(executor="auto", n_iters=n_iters,
                                         compact_every=compact_every),
                     device=dev)
    plans = dict(dsc=eng.dsc_plan.describe(), wc=eng.wc_plan.describe())
    print(f"   DSC plan: {plans['dsc']}")
    print(f"   WC  plan: {plans['wc']}")

    print("3. running SBBNNLS...")
    w, losses = eng.run()
    ls = losses.cpu().numpy()
    print(f"   loss {ls[0]:.3f} -> {ls[-1]:.5f} ({len(ls)} iterations)")
    print(f"   inspector overhead: {eng.inspector_seconds:.2f}s "
          f"(amortized across iterations, paper §4.1.2)")

    stats = eng.prune_stats(w)
    print(f"4. pruned connectome: kept {int(stats['kept'])}/"
          f"{int(stats['total'])} fibers | precision "
          f"{stats['precision']:.2f} recall {stats['recall']:.2f}")
    zeros = float((w == 0).float().mean())
    print(f"   w sparsity: {zeros:.1%} zeros (drives the compaction win)")
    return dict(w=w, losses=losses, plans=plans,
                inspector_seconds=eng.inspector_seconds, stats=stats,
                zeros=zeros)


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
