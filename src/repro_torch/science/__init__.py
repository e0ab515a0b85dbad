"""Connectome-pruning science workloads (torch counterpart of
``repro/science``).

LiFE exists to prune brain connectivity graphs: the solver layers below
(engines, formats, tuning, serving) are means to four science outputs,
which this package provides as first-class workloads:

* :mod:`~repro_torch.science.prune`: pruned connectomes from converged
  weights: nonzero-support extraction, fiber-weight summaries, and Phi
  compaction to the surviving support.
* :mod:`~repro_torch.science.crossval`: k-fold cross-validated RMSE over
  disjoint voxel folds, evaluated through any executor x format config.
* :mod:`~repro_torch.science.lesion`: virtual-lesion evaluation: remove a
  fiber bundle, warm-start the re-solve from the previous (optionally
  checkpointed) state, report evidence as the held RMSE delta on the
  bundle's voxel footprint.
* :mod:`~repro_torch.science.incremental`: convergence-driven solves,
  Phi-delta resubmission through the async serving front line, and
  coarse-to-fine multi-resolution solves riding the checkpoint/resume
  machinery.

Everything here composes the existing stack rather than adding solver
code: warm starts are plain ``sbbnnls_init(w0)`` states (iteration parity
reset: BB step history is invalid under an edited operator), and served
warm starts ride ``Job.w0``.  Solves run on the CUDA card unless a
``device`` is given; index work (folds, restrictions, lesions, supports)
is host numpy, as in the reference, and weights come back as host arrays.
"""
from repro_torch.science.crossval import (CrossvalResult, crossval_rmse,
                                          heldout_rmse, kfold_voxel_folds,
                                          restrict_to_voxels)
from repro_torch.science.incremental import (ConvergedSolve, MultiresResult,
                                             multires_solve, resubmit_delta,
                                             solve_to_convergence)
from repro_torch.science.lesion import (LesionReport, bundle_footprint,
                                        lesion_problem, virtual_lesion,
                                        warm_start_weights)
from repro_torch.science.prune import (PrunedConnectome, prune_connectome,
                                       weight_summary)

__all__ = [
    "CrossvalResult", "crossval_rmse", "heldout_rmse", "kfold_voxel_folds",
    "restrict_to_voxels",
    "ConvergedSolve", "MultiresResult", "multires_solve", "resubmit_delta",
    "solve_to_convergence",
    "LesionReport", "bundle_footprint", "lesion_problem", "virtual_lesion",
    "warm_start_weights",
    "PrunedConnectome", "prune_connectome", "weight_summary",
]
