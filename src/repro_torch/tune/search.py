"""The measurement loop every runtime search in the port shares.

Torch counterpart of ``repro/tune/search.py``.  The paper selects its
restructuring at runtime from "the average execution time for three runs";
this module is that loop, shared by the restructuring choice
(``core/restructure.autotune_plan``) and the format choice
(``formats/select``), so their outcomes stay comparable.

A call is timed to its end: when its result holds a CUDA tensor, the card
is synchronized after the warm-up and after the timed calls, so the clock
measures the device's work and not its enqueue.
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, Sequence, Tuple

import torch

#: measurement defaults, mirroring the paper's "three runs" protocol
DEFAULT_WARMUP = 1
DEFAULT_REPEATS = 3

#: process-lifetime count of :func:`time_call` invocations: a complete
#: audit of measurement work, since every search times through it
_N_MEASURED = 0


def measurement_count() -> int:
    """Total ``time_call`` invocations in this process."""
    return _N_MEASURED


def block(out: torch.Tensor) -> torch.Tensor:
    """Wait until ``out`` is computed when it lies on the card (timing
    barrier); a CPU tensor is computed when it is returned."""
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out


def time_call(fn: Callable, *args, warmup: int = DEFAULT_WARMUP,
              repeats: int = DEFAULT_REPEATS) -> float:
    """Mean seconds per blocking call after ``warmup`` warm-up calls."""
    global _N_MEASURED
    _N_MEASURED += 1
    for _ in range(warmup):
        block(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(repeats):
        out = fn(*args)
    block(out)
    return (time.perf_counter() - t0) / max(1, repeats)


def measure_candidates(candidates: Sequence, run: Callable[[object], float],
                       ) -> Tuple[int, dict]:
    """Run ``run(candidate) -> cost_seconds`` for every candidate.

    Returns (index of the cheapest candidate, {label: cost}).  Duplicate
    labels get a ``#<index>`` suffix instead of overwriting one another.
    """
    if not candidates:
        raise ValueError("need at least one candidate")
    costs = {}
    best_i, best_cost = 0, None
    for i, cand in enumerate(candidates):
        cost = float(run(cand))
        label = str(cand)
        if label in costs:
            warnings.warn(f"duplicate search candidate label {label!r}; "
                          f"keying repeat as {label}#{i}", stacklevel=2)
            label = f"{label}#{i}"
        costs[label] = cost
        if best_cost is None or cost < best_cost:
            best_i, best_cost = i, cost
    return best_i, costs
