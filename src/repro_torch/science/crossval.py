"""k-fold cross-validated prediction error.

Torch counterpart of ``repro/science/crossval.py``.  Split contract: folds
partition the *voxel* axis: every voxel id appears in exactly one fold
(disjoint + covering), so held-out rows of the measured signal are never
seen by the training solve.  Fibers are shared across folds by
construction (a streamline traverses many voxels); that is what makes
held-out prediction meaningful: weights learned on the training voxels
predict the left-out rows through the same fibers.

Restriction (:func:`restrict_to_voxels`) produces a self-consistent
:class:`~repro_torch.data.dmri.LifeProblem`: coefficients outside the
voxel subset are dropped, surviving voxel ids are remapped to a dense
``[0, len(voxels))`` range, and the signal matrix is sliced to the same
rows in the same order.  The index work is host numpy, as the reference's,
so folds and restricted problems equal the reference's array for array;
the tensors lie on the problem's device.  The restricted problem runs
through any executor x format config unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import spmv
from repro_torch.core.std import PhiTensor
from repro_torch.data.dmri import LifeProblem
from repro_torch.device import DeviceLike


def kfold_voxel_folds(n_voxels: int, k: int,
                      seed: int = 0) -> List[np.ndarray]:
    """Partition ``range(n_voxels)`` into ``k`` disjoint, covering folds.

    Args:
        n_voxels: size of the voxel axis being split.
        k: number of folds; fold sizes differ by at most one.
        seed: RNG seed for the shuffle (same seed -> same folds).

    Returns:
        List of ``k`` sorted int64 arrays; their concatenation is a
        permutation of ``range(n_voxels)``.

    Raises:
        ValueError: if ``k`` is not in ``[2, n_voxels]``.
    """
    if not 2 <= k <= n_voxels:
        raise ValueError(f"k must be in [2, {n_voxels}], got {k}")
    perm = np.random.default_rng(seed).permutation(n_voxels)
    return [np.sort(perm[i::k]).astype(np.int64) for i in range(k)]


def restrict_to_voxels(problem: LifeProblem,
                       voxels: Sequence[int]) -> LifeProblem:
    """The sub-problem over a voxel subset (ids remapped densely).

    Args:
        problem: the full problem.
        voxels: voxel ids to keep (deduplicated and sorted internally).

    Returns:
        A :class:`~repro_torch.data.dmri.LifeProblem` whose Phi holds only
        coefficients in ``voxels`` (ids remapped to ``[0, len(voxels))``
        in sorted order), with the signal rows sliced to match.  The
        fiber id space is unchanged, so weight vectors carry over.

    Raises:
        ValueError: if ``voxels`` is empty or contains out-of-range ids.
    """
    vox = np.unique(np.asarray(voxels, np.int64))
    if vox.size == 0:
        raise ValueError("voxel subset is empty")
    if vox[0] < 0 or vox[-1] >= problem.phi.n_voxels:
        raise ValueError(f"voxel ids must be in [0, {problem.phi.n_voxels}), "
                         f"got range [{vox[0]}, {vox[-1]}]")
    phi = problem.phi
    dev = phi.device
    old_v = phi.voxels.cpu().numpy().astype(np.int64)
    keep = np.nonzero(np.isin(old_v, vox))[0]
    new_v = np.searchsorted(vox, old_v[keep])
    keep_t = torch.as_tensor(keep, device=dev)
    sub = PhiTensor(
        atoms=phi.atoms[keep_t],
        voxels=torch.as_tensor(new_v, dtype=torch.int32, device=dev),
        fibers=phi.fibers[keep_t],
        values=phi.values[keep_t],
        n_atoms=phi.n_atoms, n_voxels=int(vox.size),
        n_fibers=phi.n_fibers)
    stats = dict(problem.stats)
    stats["n_coeffs"] = float(sub.n_coeffs)
    stats["n_voxels_touched"] = float(np.unique(new_v).size)
    return LifeProblem(phi=sub, dictionary=problem.dictionary,
                       b=problem.b[torch.as_tensor(vox,
                                                   device=problem.b.device)],
                       w_true=problem.w_true, stats=stats)


def heldout_rmse(problem: LifeProblem, w) -> float:
    """RMSE of the predicted signal ``M w`` against the measured signal.

    Scores with the naive COO DSC of :mod:`repro_torch.core.spmv` (the
    reference scores with its reference SpMV), so evaluation never depends
    on the executor or format under test; the error is reduced in float64.
    """
    d = problem.dictionary
    pred = spmv.dsc_naive(problem.phi, d,
                          torch.as_tensor(w, dtype=d.dtype, device=d.device))
    err = pred.double() - problem.b.to(d.device).double()
    return float(torch.sqrt(torch.mean(err ** 2)))


@dataclasses.dataclass(frozen=True)
class CrossvalResult:
    """Per-fold held-out errors plus the null-model reference.

    ``null_rmse`` is the RMSE of the empty connectome (``w = 0``; the
    signal is demeaned, so this is the RMS of the held-out rows): a
    cross-validated solve that beats it carries real evidence.
    """

    fold_rmse: List[float]
    null_rmse: float
    k: int
    n_iters: int

    @property
    def mean_rmse(self) -> float:
        """Mean held-out RMSE across folds."""
        return float(np.mean(self.fold_rmse))

    @property
    def relative_rmse(self) -> float:
        """``mean_rmse / null_rmse`` (< 1.0 = better than no connectome)."""
        return self.mean_rmse / max(self.null_rmse, 1e-30)

    def describe(self) -> str:
        """One-line human-readable summary."""
        return (f"{self.k}-fold crossval: rmse={self.mean_rmse:.5f} "
                f"(null {self.null_rmse:.5f}, "
                f"ratio {self.relative_rmse:.3f})")


def crossval_rmse(problem: LifeProblem, config=None, *, k: int = 4,
                  seed: int = 0, n_iters: Optional[int] = None,
                  cache=None, device: DeviceLike = None) -> CrossvalResult:
    """k-fold cross-validated RMSE of a LiFE solve.

    For each fold: train on the complement's voxels through a
    :class:`~repro_torch.core.life.LifeEngine` built from ``config`` (any
    executor x format combination) on ``device`` (the CUDA card by
    default), then score the held-out fold with :func:`heldout_rmse`.

    Args:
        problem: the full problem to cross-validate.
        config: :class:`~repro_torch.core.life.LifeConfig` for the training
            solves (default config when None).
        k: number of voxel folds.
        seed: fold-assignment seed.
        n_iters: training iterations per fold (``config.n_iters`` when
            None).
        cache: optional shared
            :class:`~repro_torch.core.plan_cache.PlanCache`.
        device: where the training solves run.

    Returns:
        A :class:`CrossvalResult` with per-fold and null-model RMSE.
    """
    from repro_torch.core.life import LifeConfig, LifeEngine
    cfg = config if config is not None else LifeConfig()
    iters = cfg.n_iters if n_iters is None else n_iters
    all_vox = np.arange(problem.phi.n_voxels, dtype=np.int64)
    fold_rmse: List[float] = []
    null_sq: List[float] = []
    for fold in kfold_voxel_folds(problem.phi.n_voxels, k, seed):
        train = restrict_to_voxels(problem, np.setdiff1d(all_vox, fold))
        test = restrict_to_voxels(problem, fold)
        engine = LifeEngine(train, cfg, cache, device=device)
        w, _ = engine.run(iters)
        fold_rmse.append(heldout_rmse(test, w))
        null_sq.append(float(torch.mean(test.b.double() ** 2)))
    return CrossvalResult(fold_rmse=fold_rmse,
                          null_rmse=float(np.sqrt(np.mean(null_sq))),
                          k=k, n_iters=iters)
