"""Harvest training pairs from the plan cache; train/persist the predictor.

Torch counterpart of ``repro/learn/harvest.py``, over
:meth:`repro_torch.core.plan_cache.PlanCache.iter_plans` and
:mod:`repro_torch.obs`.  The ``.npz`` plan layout and ``predictor.json``
are the reference's.  Tune examples are grouped by ``executor@backend``
with the port's backend names (``cpu`` / ``cuda``), so a predictor trained
on the card replays nothing on the CPU and the other way round.

Every measured or heuristic selection the repo makes already persists its
evidence: FormatPlans carry the ``phi_stats`` dict they were decided under,
and (since plan-cache v2) searched TunePlans do too.  Harvesting walks the
cache directory via :meth:`PlanCache.iter_plans` and turns those into
supervised pairs:

* format examples — (features, chosen format) from FormatPlans whose
  ``reason`` is "heuristic" or "autotune".  "explicit" plans are excluded
  (the user forced the format; nothing was learned about the data) and so
  are "predicted" plans (training on the model's own outputs would launder
  guesses into ground truth).
* tune examples — (features, (executor, backend), winning params + dtype)
  from TunePlans whose ``reason`` is "search".  "default"/"untuned"/
  "predicted" plans carry no measured signal.

``train_predictor`` fits the models and writes ``predictor.json`` next to
the plan entries (atomic tmp+rename, mirroring the cache's own writes; the
``.json`` suffix keeps it invisible to the cache's ``.npz``-only pruning).
``load_predictor`` memoizes by file mtime so the serving hot path pays one
stat() per cold start, not one JSON parse.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from repro_torch import obs

from .features import feature_vector
from .model import CentroidClassifier, NearestExample, Predictor

PREDICTOR_FILENAME = "predictor.json"

#: FormatPlan reasons that constitute training signal
_FORMAT_TRAIN_REASONS = ("heuristic", "autotune")
#: TunePlan reasons that constitute training signal
_TUNE_TRAIN_REASONS = ("search",)

# load memo: directory -> (mtime_ns, Predictor-or-None)
_LOAD_MEMO: dict = {}


def harvest(cache) -> Tuple[List, List]:
    """Walk ``cache`` and return (format_examples, tune_examples).

    format example: ``(x: ndarray, label: str)``
    tune example:   ``(x: ndarray, group_key: str, payload: dict)`` where
    payload is the winning tile params plus ``compute_dtype``.
    """
    fmt_examples, tune_examples = [], []
    for kind, plan in cache.iter_plans():
        x = feature_vector(plan.stats)
        if x is None:
            continue
        if kind == "format" and plan.reason in _FORMAT_TRAIN_REASONS:
            fmt_examples.append((x, plan.format))
        elif kind == "tune" and plan.reason in _TUNE_TRAIN_REASONS:
            payload = {str(k): int(v) for k, v in plan.params.items()}
            payload["compute_dtype"] = plan.compute_dtype
            key = NearestExample.group_key(plan.executor, plan.backend)
            tune_examples.append((x, key, payload))
    return fmt_examples, tune_examples


def predictor_path(directory: str) -> str:
    return os.path.join(directory, PREDICTOR_FILENAME)


def train_predictor(cache) -> Optional[Predictor]:
    """Harvest ``cache``, fit, persist ``predictor.json``; None when the
    cache holds no usable examples at all (nothing is written)."""
    if not getattr(cache, "enabled", False):
        return None
    fmt_examples, tune_examples = harvest(cache)
    if not fmt_examples and not tune_examples:
        return None

    format_model = None
    if fmt_examples:
        x = np.stack([e[0] for e in fmt_examples])
        y = [e[1] for e in fmt_examples]
        format_model = CentroidClassifier.fit(x, y)
    tune_model = None
    if tune_examples:
        x = np.stack([e[0] for e in tune_examples])
        keys = [e[1] for e in tune_examples]
        payloads = [e[2] for e in tune_examples]
        tune_model = NearestExample.fit(x, keys, payloads)

    predictor = Predictor(format_model=format_model, tune_model=tune_model,
                          n_format_examples=len(fmt_examples),
                          n_tune_examples=len(tune_examples))
    _write_predictor(cache.directory, predictor)
    if obs.SWITCH.on:
        obs.gauge("learn.train.format_examples").set(len(fmt_examples))
        obs.gauge("learn.train.tune_examples").set(len(tune_examples))
    return predictor


def _write_predictor(directory: str, predictor: Predictor) -> None:
    tmp = None
    try:
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".json.tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(predictor.to_json(), f, indent=1)
        os.replace(tmp, predictor_path(directory))
    except OSError:
        # fail-open like the plan cache itself: an unwritable directory
        # degrades to "no predictor", never to an engine error
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)


def load_predictor(directory: Optional[str]) -> Optional[Predictor]:
    """Load (memoized by mtime) the trained predictor beside a plan cache.

    Returns None when the directory is unset, the file is absent/corrupt,
    or the persisted feature schema no longer matches — every failure mode
    degrades to the next rung of the selection ladder.
    """
    if not directory:
        return None
    path = predictor_path(directory)
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        _LOAD_MEMO.pop(directory, None)
        return None
    memo = _LOAD_MEMO.get(directory)
    if memo is not None and memo[0] == mtime:
        return memo[1]
    try:
        with open(path) as f:
            predictor = Predictor.from_json(json.load(f))
    except (OSError, ValueError, KeyError, TypeError):
        predictor = None
    _LOAD_MEMO[directory] = (mtime, predictor)
    return predictor


def clear_load_memo() -> None:
    """Test hook: forget memoized predictors (e.g. across tmp dirs)."""
    _LOAD_MEMO.clear()
