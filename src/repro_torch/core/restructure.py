"""Data restructuring (paper §4.1.2) and weight compaction (§4.2.1.3).

Torch counterpart of ``repro/core/restructure.py``.  Sorting Phi along one
indirection dimension turns indirect accesses into contiguous runs of equal
index (the paper's sub-vectors); sorting by each op's *output* dimension
(voxel for DSC, fiber for WC) turns its scatter into a segment reduction.
The sorts are host inspectors, amortized over the solver's iterations.

``compact_by_weight`` drops coefficients whose fiber weight reached zero
(the paper's "the BLAS call is evaded when the scalar is zero"), an
inspector re-run amortized over the following iterations.

``autotune_plan`` (the ``auto`` executor's measured choice) arrives with
that executor in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.std import PhiTensor

SORT_DIMS = ("atom", "voxel", "fiber")


def sort_by_host(phi: PhiTensor, dim: str) -> Tuple[PhiTensor, np.ndarray]:
    """Stable host (numpy) sort along one indirection dimension.

    Returns (restructured phi, permutation); the permutation is kept so
    plans can be cached and replayed."""
    key = {"atom": phi.atoms, "voxel": phi.voxels, "fiber": phi.fibers}[dim]
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
    restructure: str             # member of SORT_DIMS
    partition: str               # "coeff" | "voxel" | "atom" | "fiber"
    order: Optional[np.ndarray] = None   # cached permutation

    def describe(self) -> str:
        return f"{self.op}: sort-by-{self.restructure}, {self.partition}-partition"
