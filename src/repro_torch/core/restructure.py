"""Data restructuring (paper §4.1.2) and weight compaction (§4.2.1.3).

Torch counterpart of ``repro/core/restructure.py``.  Sorting Phi along one
indirection dimension turns indirect accesses into contiguous runs of equal
index (the paper's sub-vectors); sorting by each op's *output* dimension
(voxel for DSC, fiber for WC) turns its scatter into a segment reduction.
The sorts are host inspectors, amortized over the solver's iterations.

``compact_by_weight`` drops coefficients whose fiber weight reached zero
(the paper's "the BLAS call is evaded when the scalar is zero"), an
inspector re-run amortized over the following iterations.

``autotune_plan`` is the paper's runtime selection: it times each
candidate a few times through :mod:`repro_torch.tune.search` and keeps the
fastest.  The ``auto`` executor chooses sort dimensions with it, and
``formats/select.py`` chooses formats with it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.std import PhiTensor

SORT_DIMS = ("atom", "voxel", "fiber")


def sort_by(phi: PhiTensor, dim: str) -> Tuple[PhiTensor, torch.Tensor]:
    """Stable sort of the coefficients along one indirection dimension, on
    the coefficients' device.

    Returns (restructured phi, permutation): the permutation is kept so
    plans can be cached and replayed."""
    key = {"atom": phi.atoms, "voxel": phi.voxels, "fiber": phi.fibers}[dim]
    order = torch.argsort(key, stable=True)
    return phi.take(order), order


def sort_by_host(phi: PhiTensor, dim: str) -> Tuple[PhiTensor, np.ndarray]:
    """Stable host (numpy) sort along one indirection dimension.

    Returns (restructured phi, permutation); the permutation is kept so
    plans can be cached and replayed.  A ``build.sort`` span covers the
    sort and the ``take`` that applies it."""
    with obs.span("build.sort", {"dim": dim, "n_coeffs": phi.n_coeffs}):
        key = {"atom": phi.atoms, "voxel": phi.voxels,
               "fiber": phi.fibers}[dim]
        order = np.argsort(key.cpu().numpy(), kind="stable")
        return phi.take(order), order


def segment_starts(sorted_ids: np.ndarray) -> np.ndarray:
    """Start offsets of each sub-vector (run of equal ids) in a sorted vector."""
    if sorted_ids.size == 0:
        return np.zeros(0, np.int64)
    change = np.nonzero(np.diff(sorted_ids))[0] + 1
    return np.concatenate([[0], change])


def compact_by_weight(phi: PhiTensor, w: torch.Tensor,
                      threshold: float = 0.0) -> PhiTensor:
    """Drop coefficients whose fiber weight is at or below ``threshold``.

    Host-side inspector (it reads ``w`` back from the device); returns a
    smaller PhiTensor on phi's device."""
    w_np = w.detach().float().cpu().numpy()
    keep = np.nonzero(w_np[phi.fibers.cpu().numpy()] > threshold)[0]
    return phi.take(keep)


@dataclasses.dataclass
class SpmvPlan:
    """Declarative restructuring + partitioning choice for one SpMV op."""

    op: str                      # "dsc" | "wc"
    restructure: str             # member of SORT_DIMS (or a format name
                                 # when the candidates are formats)
    partition: str               # "coeff" | "voxel" | "atom" | "fiber"
    order: Optional[np.ndarray] = None   # cached permutation

    def describe(self) -> str:
        return f"{self.op}: sort-by-{self.restructure}, {self.partition}-partition"


# In-process memo for autotune_plan.  Keys include phi.n_coeffs so a
# compaction (same dataset, fewer coefficients) misses instead of replaying
# a stale choice; clear_plan_cache() gives long-running services a bound.
# Persistent, content-addressed caching lives in core/plan_cache.py.
_PLAN_CACHE: Dict[Tuple, SpmvPlan] = {}


def clear_plan_cache() -> None:
    """Drop every in-process memoized plan (the dict is otherwise unbounded)."""
    _PLAN_CACHE.clear()


def autotune_plan(
    op: str,
    phi: PhiTensor,
    run: Callable[[object, str], object],
    candidates: Tuple[str, ...] = SORT_DIMS,
    repeats: int = 3,
    cache_key: Optional[Tuple] = None,
    sorter: Callable[[PhiTensor, str], Tuple] = sort_by_host,
) -> SpmvPlan:
    """Measure each candidate ``repeats`` times and keep the fastest.

    ``sorter(phi, candidate)`` builds the candidate's prepared data plus an
    optional permutation (by default a sort along one dimension);
    ``run(prepared, candidate)`` executes the op over it.  Timing goes
    through :func:`repro_torch.tune.search.time_call`, which waits for the
    card when the result lies on one.
    """
    from repro_torch.tune import search as tsearch
    full_key = None
    if cache_key is not None:
        full_key = ("plan", op, phi.n_coeffs) + cache_key
        if full_key in _PLAN_CACHE:
            return _PLAN_CACHE[full_key]
    prepared_orders = {}

    def measure(dim: str) -> float:
        prepared, order = sorter(phi, dim)
        prepared_orders[dim] = order
        return tsearch.time_call(lambda: run(prepared, dim),
                                 warmup=1, repeats=repeats)

    best_i, _ = tsearch.measure_candidates(tuple(candidates), measure)
    best_dim = tuple(candidates)[best_i]
    # output-side sorts admit segment (sync-free) partitioning; input-side
    # sorts fall back to coefficient partitioning (paper Tables 3/4)
    out_dim = "voxel" if op == "dsc" else "fiber"
    partition = out_dim if best_dim == out_dim else "coeff"
    plan = SpmvPlan(op=op, restructure=best_dim, partition=partition,
                    order=prepared_orders[best_dim])
    if full_key is not None:
        _PLAN_CACHE[full_key] = plan
    return plan
