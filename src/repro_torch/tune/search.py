"""The measurement loop every runtime search in the port shares.

Torch counterpart of ``repro/tune/search.py``.  The paper selects its
restructuring at runtime from "the average execution time for three runs";
this module is that loop, shared by the restructuring choice
(``core/restructure.autotune_plan``), the format choice
(``formats/select``) and the kernel autotuner (``tune/tuner``), so their
outcomes stay comparable.

A call is timed to its end.  When the warm-up's result lies on the card,
the warm-up goes on for at least :data:`CUDA_WARM_SECONDS` and the timed
calls are bracketed by CUDA events, so the cost is the device's time for
them; otherwise the host clock times them.
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, Sequence, Tuple

import torch

#: measurement defaults, mirroring the paper's "three runs" protocol
DEFAULT_WARMUP = 1
DEFAULT_REPEATS = 3
#: on the card, warm-up calls go on until this long has passed: with one
#: warm-up call, some freshly built candidates measured up to 3x their
#: cost in a later step, and with this warm-up none did (PERF.md §6)
CUDA_WARM_SECONDS = 0.02

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
    """Mean seconds per call after ``warmup`` warm-up calls: between CUDA
    events when the warm-up's result lies on the card (warm-up extended
    to :data:`CUDA_WARM_SECONDS`), else by the host clock until the last
    result is computed."""
    global _N_MEASURED
    _N_MEASURED += 1
    out = None
    for _ in range(warmup):
        out = block(fn(*args))
    if out is not None and out.is_cuda:
        warm_until = time.perf_counter() + CUDA_WARM_SECONDS
        while time.perf_counter() < warm_until:
            block(fn(*args))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn(*args)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3 / max(1, repeats)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args)
    if out is not None:
        block(out)
    return (time.perf_counter() - t0) / max(1, repeats)


def measure_candidates(candidates: Sequence, run: Callable[[object], float],
                       ) -> Tuple[int, dict]:
    """Run ``run(candidate) -> cost_seconds`` for every candidate.

    Returns (index of the cheapest candidate, {label: cost}).  A dict
    candidate is labelled by its sorted ``k=v`` pairs (nested dicts
    likewise), anything else by ``str``, as the reference labels them, so
    persisted measurements carry the reference's keys.  Duplicate labels
    get a ``#<index>`` suffix instead of overwriting one another.
    """
    if not candidates:
        raise ValueError("need at least one candidate")
    costs = {}
    best_i, best_cost = 0, None
    for i, cand in enumerate(candidates):
        cost = float(run(cand))
        label = _label(cand)
        if label in costs:
            warnings.warn(f"duplicate search candidate label {label!r}; "
                          f"keying repeat as {label}#{i}", stacklevel=2)
            label = f"{label}#{i}"
        costs[label] = cost
        if best_cost is None or cost < best_cost:
            best_i, best_cost = i, cost
    return best_i, costs


def _label(cand) -> str:
    if isinstance(cand, dict):
        parts = []
        for k in sorted(cand):
            v = cand[k]
            parts.append(f"{k}={_label(v) if isinstance(v, dict) else v}")
        return ",".join(parts)
    return str(cand)
