"""Feature schema for learned format/executor selection.

Copy of ``repro/learn/features.py`` (the port imports nothing of the
reference package); the schema number, the names and the transform are the
reference's, so each package reads the other's ``predictor.json``.

Chen et al. (arXiv:1805.11938) predict the winning SpMV format from matrix
features; ours come for free: ``repro_torch/core/inspector.py:phi_stats`` already
computes run-length and density statistics for every selection decision,
and the selector persists them inside each :class:`~repro_torch.formats.base
.FormatPlan` (and, since the learn subsystem landed, each searched
:class:`~repro_torch.tune.plan.TunePlan`).  This module pins the *order* and the
*transform* of those statistics so a model trained from harvested plans and
a predictor consulted at cold start score the exact same vector.

``FEATURE_SCHEMA`` versions the (names, transform) pair: a persisted
predictor records it, and loading refuses a mismatch — silently scoring
features in a different order would be a wrong-but-plausible prediction,
the worst failure mode a zero-measurement path can have.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

#: bump on any change to FEATURE_NAMES or the transform below
FEATURE_SCHEMA = 1

#: phi_stats keys, in scoring order (see core/inspector.py:phi_stats)
FEATURE_NAMES = (
    "n_coeffs", "nc_per_voxel", "nc_per_fiber", "nc_per_atom",
    "dsc.rows_touched", "dsc.run_mean", "dsc.run_p99", "dsc.run_max",
    "dsc.sell_width", "dsc.sell_overhead",
    "wc.rows_touched", "wc.run_mean", "wc.run_p99", "wc.run_max",
    "wc.sell_width", "wc.sell_overhead",
)


def feature_vector(stats: Mapping[str, float]) -> Optional[np.ndarray]:
    """``phi_stats`` dict -> float64 feature vector, or None when any
    feature is missing (a plan persisted before the key existed must be
    skipped by harvesting, not padded with a guess).

    Every statistic is a nonnegative magnitude (counts, widths, ratios)
    with a heavy-tailed spread across datasets, so the transform is
    ``log1p``: centroid distances then compare scale *ratios* rather than
    letting ``n_coeffs`` drown the run-length shape features.
    """
    try:
        xs = [float(stats[name]) for name in FEATURE_NAMES]
    except (KeyError, TypeError, ValueError):
        return None
    x = np.asarray(xs, np.float64)
    if not np.all(np.isfinite(x)):
        return None
    return np.log1p(np.maximum(x, 0.0))
