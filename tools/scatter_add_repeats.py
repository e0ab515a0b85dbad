"""Whether the plain scatter-add of the naive ops repeats bit for bit on
the card: ``index_add_`` (atomics on CUDA) against
``core/spmv.py:scatter_add`` (``index_put_(accumulate=True)``: the indices
sorted, each output's terms summed in order), twenty repeats each at the
DSC and WC shapes of one problem, with their CUDA-event times; then the
``naive`` and ``alto`` executors and an ``alto`` cohort, each run twice.

    python3 tools/scatter_add_repeats.py

Needs one CUDA card.  Prints the card's name and power limit, one line per
case, and last one JSON line of the same numbers.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPEATS = 20
TIMED = 50
PROBLEM = dict(n_fibers=5000, n_theta=96, n_atoms=96, grid=(32, 32, 32))
COHORT = dict(n_fibers=2000, n_theta=96, n_atoms=96, grid=(24, 24, 24))
ITERS = 40


def event_ms(fn) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / TIMED


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("scatter_add_repeats: no CUDA device is visible",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import spmv
    from repro_torch.core.batched import BatchedLifeEngine
    from repro_torch.core.life import LifeConfig, LifeEngine
    from repro_torch.data.dmri import synth_cohort, synth_connectome
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    p = synth_connectome(**PROBLEM, seed=0, device="cuda")
    phi, d = p.phi, p.dictionary
    g = torch.Generator(device="cuda").manual_seed(0)
    w = torch.rand(phi.n_fibers, generator=g, device="cuda")
    y = torch.randn(phi.n_voxels, d.shape[1], generator=g, device="cuda")
    contrib = d[phi.atoms] * (w[phi.fibers] * phi.values)[:, None]
    dots = (d[phi.atoms] * y[phi.voxels]).sum(1) * phi.values

    def y_zeros():
        return torch.zeros(phi.n_voxels, d.shape[1], device="cuda")

    def w_zeros():
        return torch.zeros(phi.n_fibers, device="cuda")

    cases = {
        "index_add_ dsc": lambda: y_zeros().index_add_(0, phi.voxels,
                                                      contrib),
        "scatter_add dsc": lambda: spmv.scatter_add(y_zeros(), phi.voxels,
                                                    contrib),
        "index_add_ wc": lambda: w_zeros().index_add_(0, phi.fibers, dots),
        "scatter_add wc": lambda: spmv.scatter_add(w_zeros(), phi.fibers,
                                                   dots),
    }
    out = {"coefficients": phi.n_coeffs, "ops": {}, "engines": {}}
    for name, fn in cases.items():
        first = fn()
        same = sum(torch.equal(first, fn()) for _ in range(REPEATS))
        ms = event_ms(fn)
        out["ops"][name] = dict(repeats=same, of=REPEATS, ms=ms)
        print(f"{name}: {same}/{REPEATS} repeats bit for bit; {ms:.4f} ms "
              f"(Nc {phi.n_coeffs})")

    cohort = synth_cohort(4, base_seed=0, **COHORT, device="cuda")
    cfg = dict(n_iters=ITERS, plan_cache_dir="")
    engines = {
        "naive": lambda: LifeEngine(p, LifeConfig(executor="naive", **cfg),
                                    device="cuda"),
        "alto": lambda: LifeEngine(p, LifeConfig(format="alto", **cfg),
                                   device="cuda"),
        "alto cohort": lambda: BatchedLifeEngine(
            cohort, LifeConfig(format="alto", **cfg), device="cuda"),
    }
    for name, make in engines.items():
        eng = make()
        (w1, l1), (w2, l2) = eng.run(), eng.run()
        same = torch.equal(w1, w2) and torch.equal(l1, l2)
        out["engines"][name] = same
        print(f"{name}: two runs of {ITERS} iterations bit for bit: {same}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
