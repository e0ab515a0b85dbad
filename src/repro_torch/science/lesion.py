"""Virtual-lesion evaluation with warm-started re-solves.

Torch counterpart of ``repro/science/lesion.py``.  A virtual lesion asks:
how much worse does the model explain the signal when one fiber bundle is
removed?  The procedure:

1. remove the bundle's coefficients from Phi (the fiber id space is
   kept: ``n_fibers`` unchanged, so weight vectors stay compatible),
2. re-solve, warm-starting from the previous converged weights with the
   lesioned entries zeroed (a lesioned fiber has a zero column, so its
   gradient is zero and the weight stays *exactly* zero),
3. report evidence as the RMSE delta on the bundle's voxel footprint, the
   voxels the lesioned streamlines traversed, where the loss of
   explanatory power is concentrated.

The warm start is the point: the lesioned optimum is close to the full
optimum everywhere off the bundle, so the re-solve converges in a
fraction of the cold iteration count.  The previous state may come from a
live solve or from a service checkpoint
(:func:`repro_torch.checkpoint.manager.restore_job`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.data.dmri import LifeProblem
from repro_torch.device import DeviceLike
from repro_torch.science.crossval import heldout_rmse, restrict_to_voxels
from repro_torch.science.incremental import (ConvergedSolve,
                                             solve_to_convergence)
from repro_torch.science.prune import host_weights


def lesion_problem(problem: LifeProblem,
                   fiber_ids: Sequence[int]) -> LifeProblem:
    """Remove a fiber bundle's coefficients, keeping the fiber id space.

    Args:
        problem: the full problem.
        fiber_ids: fiber ids to lesion.

    Returns:
        A :class:`~repro_torch.data.dmri.LifeProblem` whose Phi has no
        coefficients on the lesioned fibers but the same ``n_fibers``
        (weight-vector shape compatibility, the warm-start invariant), the
        same signal, and ``w_true`` zeroed on the bundle.

    Raises:
        ValueError: on an empty bundle or out-of-range fiber ids.
    """
    ids = np.unique(np.asarray(fiber_ids, np.int64))
    if ids.size == 0:
        raise ValueError("lesion bundle is empty")
    if ids[0] < 0 or ids[-1] >= problem.phi.n_fibers:
        raise ValueError(f"fiber ids must be in [0, {problem.phi.n_fibers}),"
                         f" got range [{ids[0]}, {ids[-1]}]")
    phi = problem.phi
    fib = phi.fibers.cpu().numpy().astype(np.int64)
    keep = np.nonzero(~np.isin(fib, ids))[0]
    sub = phi.take(keep)
    w_true = problem.w_true.clone()
    w_true[torch.as_tensor(ids, device=w_true.device)] = 0.0
    stats = dict(problem.stats)
    stats["n_coeffs"] = float(sub.n_coeffs)
    return LifeProblem(phi=sub, dictionary=problem.dictionary,
                       b=problem.b, w_true=w_true, stats=stats,
                       grid=problem.grid)


def warm_start_weights(w_prev, fiber_ids: Sequence[int]) -> np.ndarray:
    """Previous weights with the lesioned entries zeroed (a host array).

    This is the valid warm start for the lesioned problem: off-bundle
    weights carry over (the optimum moved little there), on-bundle
    weights are pinned at zero where the gradient can never move them.
    The solver state built from it resets the iteration counter: BB step
    history from the unlesioned operator is not reused.
    """
    w0 = host_weights(w_prev).copy()
    w0[np.asarray(fiber_ids, np.int64)] = 0.0
    return w0


def bundle_footprint(problem: LifeProblem,
                     fiber_ids: Sequence[int]) -> np.ndarray:
    """Sorted unique voxel ids traversed by the bundle's coefficients."""
    fib = problem.phi.fibers.cpu().numpy().astype(np.int64)
    mask = np.isin(fib, np.asarray(fiber_ids, np.int64))
    return np.unique(problem.phi.voxels.cpu().numpy().astype(np.int64)[mask])


@dataclasses.dataclass
class LesionReport:
    """Evidence for one virtual lesion.

    ``evidence`` is the RMSE increase on the bundle's voxel footprint when
    the bundle is removed and the model re-fit; positive evidence means
    the bundle explains signal no other fiber can absorb.  Weights are
    host arrays.
    """

    bundle: np.ndarray           # lesioned fiber ids
    footprint: np.ndarray        # voxel ids the bundle traversed
    rmse_full: float             # footprint RMSE, full connectome
    rmse_lesioned: float         # footprint RMSE, lesioned + re-fit
    evidence: float              # rmse_lesioned - rmse_full
    iters_warm: int              # re-solve iterations (warm-started)
    iters_full: int              # full solve iterations (0 if w was given)
    w_full: np.ndarray
    w_lesioned: np.ndarray

    def describe(self) -> str:
        """Evidence table (one row per quantity), ready to print."""
        rows = [
            ("bundle fibers", f"{self.bundle.size}"),
            ("footprint voxels", f"{self.footprint.size}"),
            ("rmse (full)", f"{self.rmse_full:.6f}"),
            ("rmse (lesioned)", f"{self.rmse_lesioned:.6f}"),
            ("evidence (delta)", f"{self.evidence:+.6f}"),
            ("warm re-solve iters", f"{self.iters_warm}"),
        ]
        if self.iters_full:
            rows.append(("cold full-solve iters", f"{self.iters_full}"))
        width = max(len(k) for k, _ in rows)
        return "\n".join(f"{k:<{width}}  {v}" for k, v in rows)


def virtual_lesion(problem: LifeProblem, bundle: Sequence[int],
                   config=None, *, w_full=None,
                   ckpt_dir: Optional[str] = None,
                   job_id: Optional[str] = None,
                   rtol: float = 1e-4, chunk: int = 8,
                   max_iters: int = 400, cache=None,
                   device: DeviceLike = None) -> LesionReport:
    """Run one virtual-lesion evaluation.

    The previous converged weights come from (in precedence order) the
    ``w_full`` argument, a checkpointed service job (``ckpt_dir`` /
    ``job_id``: the solve warm-starts from the checkpointed weights rather
    than from zero), or a cold full solve run here.

    Args:
        problem: the full problem.
        bundle: fiber ids to lesion.
        config: :class:`~repro_torch.core.life.LifeConfig` for the solves
            (default config when None).
        w_full: previous converged full-connectome weights.
        ckpt_dir: service checkpoint directory holding the full solve.
        job_id: job id inside that checkpoint.
        rtol / chunk / max_iters: convergence parameters (see
            :func:`~repro_torch.science.incremental.solve_to_convergence`).
        cache: optional shared plan cache.
        device: where the solves run (the CUDA card by default).

    Returns:
        A :class:`LesionReport` with the RMSE-delta evidence and the warm
        re-solve iteration count.

    Raises:
        KeyError: if ``job_id`` is not present in the checkpoint.
        ValueError: on an invalid bundle (see :func:`lesion_problem`).
    """
    from repro_torch.core.life import LifeConfig, LifeEngine
    cfg = config if config is not None else LifeConfig()
    ids = np.unique(np.asarray(bundle, np.int64))
    iters_full = 0
    if w_full is None and ckpt_dir is not None:
        from repro_torch.checkpoint.manager import restore_job
        if job_id is None:
            raise ValueError("ckpt_dir given without job_id")
        arrays, _meta = restore_job(ckpt_dir, job_id)
        w_full = arrays["w"]
    if w_full is None:
        cold = solve_to_convergence(
            LifeEngine(problem, cfg, cache, device=device), rtol=rtol,
            chunk=chunk, max_iters=max_iters)
        w_full = cold.w
        iters_full = cold.iters
    w_full = host_weights(w_full)

    lesioned = lesion_problem(problem, ids)
    warm: ConvergedSolve = solve_to_convergence(
        LifeEngine(lesioned, cfg, cache, device=device),
        w0=warm_start_weights(w_full, ids),
        rtol=rtol, chunk=chunk, max_iters=max_iters)

    footprint = bundle_footprint(problem, ids)
    rmse_full = heldout_rmse(restrict_to_voxels(problem, footprint), w_full)
    rmse_lesioned = heldout_rmse(restrict_to_voxels(lesioned, footprint),
                                 warm.w)
    return LesionReport(bundle=ids, footprint=footprint,
                        rmse_full=rmse_full, rmse_lesioned=rmse_lesioned,
                        evidence=rmse_lesioned - rmse_full,
                        iters_warm=warm.iters, iters_full=iters_full,
                        w_full=w_full, w_lesioned=warm.w)
