"""Pruned connectomes from converged SBBNNLS weights.

Torch counterpart of ``repro/science/prune.py``.  Pruning semantics: a
fiber survives iff it is *structurally present* (contributes at least one
Phi coefficient) **and** its converged weight exceeds the threshold.  The
structural clause matters for edited connectomes: a fiber whose
coefficients were all removed (a virtual lesion) has a zero column, so the
solver's gradient never moves its weight; without the structural test a
cold-started solve would report such a fiber at its initial weight 1.0
despite contributing nothing to the signal.

The support is a deterministic function of the weight vector alone, read
on the host, so the same weights give the same support on the card and on
the CPU.  The compacted Phi is
:func:`repro_torch.core.restructure.compact_by_weight`'s, on the problem's
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.restructure import compact_by_weight
from repro_torch.core.std import PhiTensor
from repro_torch.data.dmri import LifeProblem


def host_weights(w) -> np.ndarray:
    """A weight vector (tensor on any device, or array-like) as a host
    numpy array."""
    if isinstance(w, torch.Tensor):
        return w.detach().cpu().numpy()
    return np.asarray(w)


@dataclasses.dataclass(frozen=True)
class PrunedConnectome:
    """One pruning result: surviving support + Phi compacted onto it.

    ``support`` is sorted ascending and int64; ``weights`` aligns with it
    elementwise.  ``phi`` holds only coefficients of surviving fibers but
    keeps the original fiber id space (``n_fibers`` unchanged), so weight
    vectors stay shape-compatible with the unpruned problem, the invariant
    every warm start relies on.
    """

    support: np.ndarray          # (n_kept,) int64, sorted fiber ids
    weights: np.ndarray          # (n_kept,) float weights on the support
    phi: PhiTensor               # compacted to the surviving support
    n_fibers_total: int
    threshold: float

    @property
    def n_kept(self) -> int:
        """Number of surviving fibers."""
        return int(self.support.size)

    @property
    def keep_fraction(self) -> float:
        """Surviving fibers / total fibers."""
        return self.n_kept / max(1, self.n_fibers_total)

    def weight_of(self, fiber_id: int) -> float:
        """The pruned weight of one fiber (exactly 0.0 off the support)."""
        i = np.searchsorted(self.support, fiber_id)
        if i < self.support.size and self.support[i] == fiber_id:
            return float(self.weights[i])
        return 0.0

    def describe(self) -> str:
        """One-line human-readable summary."""
        return (f"pruned connectome: {self.n_kept}/{self.n_fibers_total} "
                f"fibers kept ({100 * self.keep_fraction:.1f}%), "
                f"{self.phi.n_coeffs} coefficients, "
                f"threshold={self.threshold:g}")


def prune_connectome(problem: LifeProblem, w,
                     threshold: float = 1e-6) -> PrunedConnectome:
    """Extract the pruned connectome from a converged weight vector.

    Args:
        problem: the solved :class:`~repro_torch.data.dmri.LifeProblem`.
        w: converged weights, shape ``(n_fibers,)`` (tensor or numpy).
        threshold: a fiber survives iff ``w[fiber] > threshold`` and it
            has at least one Phi coefficient.

    Returns:
        A :class:`PrunedConnectome` whose ``phi`` is the input Phi
        compacted onto the surviving support.

    Raises:
        ValueError: if ``w`` does not match the problem's fiber count.
    """
    w_np = host_weights(w)
    nf = problem.phi.n_fibers
    if w_np.shape != (nf,):
        raise ValueError(f"w has shape {w_np.shape}, expected ({nf},)")
    structural = np.zeros(nf, bool)
    structural[problem.phi.fibers.cpu().numpy()] = True
    kept = (w_np > threshold) & structural
    support = np.nonzero(kept)[0].astype(np.int64)
    phi = compact_by_weight(problem.phi, torch.as_tensor(w_np), threshold)
    return PrunedConnectome(support=support,
                            weights=w_np[support].copy(),
                            phi=phi, n_fibers_total=nf,
                            threshold=float(threshold))


def weight_summary(w, threshold: float = 1e-6) -> Dict[str, float]:
    """Summary statistics of a weight vector's surviving mass.

    Args:
        w: weight vector (tensor or numpy).
        threshold: support cut, as in :func:`prune_connectome`.

    Returns:
        Dict with ``kept``/``total``/``keep_fraction`` counts and the
        min/median/max/sum of the surviving weights (zeros when the
        support is empty).
    """
    w_np = host_weights(w)
    on = w_np[w_np > threshold]
    out = dict(kept=float(on.size), total=float(w_np.size),
               keep_fraction=float(on.size) / max(1, w_np.size))
    if on.size:
        out.update(w_min=float(on.min()), w_median=float(np.median(on)),
                   w_max=float(on.max()), w_sum=float(on.sum()))
    else:
        out.update(w_min=0.0, w_median=0.0, w_max=0.0, w_sum=0.0)
    return out
