"""Warm-started incremental solves.

Torch counterpart of ``repro/science/incremental.py``.  Three layers of
"don't start from zero":

* :func:`solve_to_convergence`: the convergence-driven driver the science
  workloads share: step an engine in chunks until the best loss stops
  improving, counting iterations.  Warm vs cold comparisons are this
  function with and without a ``w0``.  The stopping rule reads each
  chunk's losses back to the host, one sync per chunk.
* :func:`resubmit_delta`: a Phi-delta resubmission: an edited problem
  (lesioned tractogram, new acquisition of the same subject) goes back
  through the async serving front line
  (:class:`~repro_torch.serve.frontend.LifeFrontend`) as a repeat-visit job
  whose ``w0`` is the previous converged weights.
* :func:`multires_solve`: coarse-to-fine multi-resolution: solve on a
  voxel-coarsened problem first, then warm-start the fine solve from the
  coarse weights (weights are per-fiber, so they transfer across voxel
  resolutions unchanged).  Each level's result is checkpointed through
  :mod:`repro_torch.checkpoint.manager` in the reference's layout; a
  killed multires run resumes at the first unfinished level, and either
  package resumes the other's checkpoints.

Warm-start state-reuse rule (also enforced by the serving layer): a
previous weight vector is a valid start for an edited Phi iff the fiber
id space is unchanged; the iteration counter is always reset
(``sbbnnls_init``) because the BB step history was computed under a
different operator.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.data.dmri import LifeProblem, coarsen_problem
from repro_torch.device import DeviceLike
from repro_torch.science.prune import host_weights


@dataclasses.dataclass
class ConvergedSolve:
    """Result of one convergence-driven solve.

    ``iters`` counts SBBNNLS iterations actually run (a multiple of the
    chunk size); ``converged`` is False when ``max_iters`` elapsed
    before the stopping rule fired.  ``losses`` is a host array.
    """

    state: object                # final SbbnnlsState (on the device)
    iters: int
    losses: np.ndarray           # per-iteration loss trace
    converged: bool

    @property
    def w(self) -> np.ndarray:
        """Final weights as a host array."""
        return host_weights(self.state.w)


def solve_to_convergence(engine, w0=None, *, rtol: float = 1e-4,
                         chunk: int = 8,
                         max_iters: int = 400) -> ConvergedSolve:
    """Step ``engine`` until the best loss stops improving.

    The stopping rule compares the best (minimum) loss seen so far across
    chunks, robust to BB's non-monotone per-iteration losses: after each
    chunk, stop once the improvement over the previous best is within
    ``rtol`` (relative).  A warm start near the fixed point therefore
    stops after two chunks; a cold start keeps going while real progress
    is being made.

    Args:
        engine: a :class:`~repro_torch.core.life.LifeEngine` (or anything
            with ``init_state``/``step`` and a bound problem).
        w0: optional warm-start weights (tensor or numpy); None starts
            from the engine's all-ones default.
        rtol: relative best-loss improvement below which the solve is
            declared converged.
        chunk: iterations per step call (convergence granularity).
        max_iters: hard iteration cap.

    Returns:
        A :class:`ConvergedSolve` with the final state and the iteration
        count.
    """
    d = engine.problem.dictionary
    state = engine.init_state(
        None if w0 is None else torch.as_tensor(w0, dtype=d.dtype,
                                                device=d.device))
    losses: List[np.ndarray] = []
    best: Optional[float] = None
    done = 0
    converged = False
    while done < max_iters:
        k = min(chunk, max_iters - done)
        state, ls = engine.step(state, k)
        ls_np = ls.detach().cpu().numpy()
        losses.append(ls_np)
        done += k
        cur = float(np.min(ls_np))
        if best is not None and best - cur <= rtol * max(abs(best), 1e-30):
            converged = True
            break
        best = cur if best is None else min(best, cur)
    return ConvergedSolve(state=state, iters=done,
                          losses=np.concatenate(losses), converged=converged)


def resubmit_delta(frontend, problem: LifeProblem, w_prev, *,
                   lesioned: Optional[Sequence[int]] = None,
                   **submit_kwargs):
    """Resubmit an edited problem as a warm-started repeat-visit job.

    Args:
        frontend: a running
            :class:`~repro_torch.serve.frontend.LifeFrontend`.
        problem: the edited problem (same fiber id space as the solve
            that produced ``w_prev``).
        w_prev: previous converged weights, shape ``(n_fibers,)``.
        lesioned: fiber ids whose weights are zeroed in the warm start
            (they no longer have coefficients, so their gradient is zero
            and they stay exactly zero).
        **submit_kwargs: forwarded to
            :meth:`~repro_torch.serve.frontend.LifeFrontend.submit_async`
            (n_iters, priority, format, ...).

    Returns:
        The :class:`~repro_torch.serve.frontend.JobHandle` of the warm
        job.

    Raises:
        ValueError: if ``w_prev`` does not match the problem's fiber
            count.
    """
    w0 = host_weights(w_prev).copy()
    if w0.shape != (problem.phi.n_fibers,):
        raise ValueError(f"w_prev has shape {w0.shape}, expected "
                         f"({problem.phi.n_fibers},)")
    if lesioned is not None:
        w0[np.asarray(lesioned, np.int64)] = 0.0
    return frontend.submit_async(problem, w0=w0, **submit_kwargs)


@dataclasses.dataclass
class MultiresResult:
    """Per-level iteration counts plus the final fine-level solve."""

    levels: List[dict]           # [{"factor", "n_voxels", "iters", ...}]
    final: ConvergedSolve
    resumed_at: int              # first level actually run (ckpt resume)

    @property
    def total_iters(self) -> int:
        """Iterations summed over all levels run in this incarnation."""
        return int(sum(lv["iters"] for lv in self.levels))

    def describe(self) -> str:
        """One-line per-level summary."""
        steps = " -> ".join(
            f"{lv['factor']}x/{lv['n_voxels']}vox:{lv['iters']}it"
            f"{'' if lv.get('ran', True) else ' (ckpt)'}"
            for lv in self.levels)
        return f"multires {steps}"


def multires_solve(problem: LifeProblem, config=None, *,
                   factors: Tuple[int, ...] = (2,),
                   grid: Optional[Tuple[int, int, int]] = None,
                   rtol: float = 1e-4, chunk: int = 8,
                   max_iters: int = 400, ckpt_dir: Optional[str] = None,
                   keep: int = 3, cache=None,
                   device: DeviceLike = None) -> MultiresResult:
    """Coarse-to-fine solve: each level warm-starts the next.

    Levels are the problem coarsened by each ``factors`` entry (coarsest
    first) followed by the full-resolution problem.  Weights are
    per-fiber, so a level's converged weights warm-start the next level
    directly.  With ``ckpt_dir`` set, every finished level is saved
    through the checkpoint manager (atomic, retained) and a rerun skips
    levels already on disk.

    Args:
        problem: the full-resolution problem; its ``grid`` (or the
            ``grid`` argument) is required for coarsening.
        config: :class:`~repro_torch.core.life.LifeConfig` shared by all
            levels (default config when None).
        factors: coarsening factors, strictly decreasing, all > 1.
        grid: voxel grid override when ``problem.grid`` is unset.
        rtol / chunk / max_iters: per-level convergence parameters
            (see :func:`solve_to_convergence`).
        ckpt_dir: checkpoint directory enabling level-wise resume.
        keep: checkpoint retention (levels kept on disk).
        cache: optional shared plan cache for the level engines.
        device: where the level solves run (the CUDA card by default).

    Returns:
        A :class:`MultiresResult`; ``final`` is the full-resolution
        solve.

    Raises:
        ValueError: on a non-decreasing or <= 1 factor sequence.
    """
    from repro_torch.core.life import LifeConfig, LifeEngine
    cfg = config if config is not None else LifeConfig()
    if any(f <= 1 for f in factors):
        raise ValueError(f"factors must all be > 1, got {factors}")
    if list(factors) != sorted(factors, reverse=True):
        raise ValueError(f"factors must be coarsest-first (decreasing), "
                         f"got {factors}")
    probs = [coarsen_problem(problem, f, grid=grid) for f in factors]
    probs.append(problem)
    level_factors = list(factors) + [1]

    w: Optional[np.ndarray] = None
    start = 0
    levels: List[dict] = []
    if ckpt_dir:
        latest = ckpt.load_latest(ckpt_dir)
        if latest is not None:
            step, flat, manifest = latest
            saved = manifest.get("multires", {})
            if saved.get("factors") == list(level_factors) and "w" in flat:
                start = int(step) + 1
                w = flat["w"].numpy()
                for li in range(start):
                    levels.append(dict(factor=level_factors[li],
                                       n_voxels=probs[li].phi.n_voxels,
                                       iters=0, converged=True, ran=False))

    result: Optional[ConvergedSolve] = None
    for li in range(start, len(probs)):
        engine = LifeEngine(probs[li], cfg, cache, device=device)
        result = solve_to_convergence(engine, w0=w, rtol=rtol, chunk=chunk,
                                      max_iters=max_iters)
        w = result.w
        levels.append(dict(factor=level_factors[li],
                           n_voxels=probs[li].phi.n_voxels,
                           iters=result.iters, converged=result.converged,
                           ran=True))
        if ckpt_dir:
            ckpt.save(ckpt_dir, li, {"w": w},
                      meta={"multires": {"factors": list(level_factors),
                                         "level": li}},
                      keep=keep)
    if result is None:
        # every level (the fine one included) was already checkpointed:
        # re-derive the final state from the stored weights without
        # re-running, the resume path's fast exit
        engine = LifeEngine(probs[-1], cfg, cache, device=device)
        d = engine.problem.dictionary
        state = engine.init_state(torch.as_tensor(w, dtype=d.dtype,
                                                  device=d.device))
        result = ConvergedSolve(state=state, iters=0,
                                losses=np.zeros((0,)), converged=True)
    return MultiresResult(levels=levels, final=result, resumed_at=start)
