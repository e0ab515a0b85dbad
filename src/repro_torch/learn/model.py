"""Dependency-free predictor over plan-cache harvests.

Copy of ``repro/learn/model.py``: the same fits and the same JSON, so a
model fitted by either package on the same examples serializes equal.

Two tiny models, both numpy-only (no sklearn — the container pins its
dependency set):

* :class:`CentroidClassifier` — nearest-centroid over z-scored log1p
  features.  Predicts the winning *format* (and, reused, the winning
  executor family).  Centroids degrade gracefully: prediction can be
  restricted to the caller's ``allowed`` candidate set, and returns
  ``None`` when no allowed class was ever trained — the caller falls back
  down the ladder (heuristic, then measurement) instead of guessing.
* :class:`NearestExample` — 1-nearest-neighbour lookup that replays the
  *tile params* of the most similar trained dataset.  Tile spaces are
  discrete grids keyed by executor, so regression would invent invalid
  points; copying the nearest winner's exact params is both simpler and
  always a legal configuration.

Both serialize to plain JSON (``Predictor.to_json``/``from_json``) so the
trained model lives next to the plan cache as ``predictor.json`` — readable
in a pager, diffable in review, and immune to the cache's ``.npz``-only
pruning.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .features import FEATURE_NAMES, FEATURE_SCHEMA, feature_vector

_EPS = 1e-9


def _standardize(x: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return (x - mean) / np.maximum(std, _EPS)


@dataclass
class CentroidClassifier:
    """Nearest-centroid over standardized features."""

    mean: np.ndarray
    std: np.ndarray
    labels: Tuple[str, ...]
    centroids: np.ndarray  # (n_labels, n_features), standardized space
    counts: Tuple[int, ...]

    @classmethod
    def fit(cls, x: np.ndarray, y: Sequence[str]) -> "CentroidClassifier":
        labels = tuple(sorted(set(y)))
        mean = x.mean(axis=0)
        std = x.std(axis=0)
        xs = _standardize(x, mean, std)
        cents, counts = [], []
        for lab in labels:
            mask = np.asarray([yi == lab for yi in y])
            cents.append(xs[mask].mean(axis=0))
            counts.append(int(mask.sum()))
        return cls(mean=mean, std=std, labels=labels,
                   centroids=np.asarray(cents), counts=tuple(counts))

    def predict(self, x: np.ndarray,
                allowed: Optional[Sequence[str]] = None) -> Optional[str]:
        """Closest trained class to ``x``, restricted to ``allowed``.

        Returns None when no allowed class has a centroid — the caller
        must fall back, never receive an out-of-set label.
        """
        idx = [i for i, lab in enumerate(self.labels)
               if allowed is None or lab in allowed]
        if not idx:
            return None
        xs = _standardize(np.asarray(x, np.float64), self.mean, self.std)
        d = np.linalg.norm(self.centroids[idx] - xs, axis=1)
        return self.labels[idx[int(np.argmin(d))]]

    def to_json(self) -> dict:
        return {
            "mean": self.mean.tolist(),
            "std": self.std.tolist(),
            "labels": list(self.labels),
            "centroids": self.centroids.tolist(),
            "counts": list(self.counts),
        }

    @classmethod
    def from_json(cls, obj: Mapping) -> "CentroidClassifier":
        return cls(mean=np.asarray(obj["mean"], np.float64),
                   std=np.asarray(obj["std"], np.float64),
                   labels=tuple(obj["labels"]),
                   centroids=np.asarray(obj["centroids"], np.float64),
                   counts=tuple(int(c) for c in obj["counts"]))


@dataclass
class NearestExample:
    """1-NN replay of tile params from the most similar trained dataset.

    Examples are grouped by ``(executor, backend)`` group key: a winning
    row_tile for `kernel-sell` on cpu says nothing about `kernel-fcoo`
    seg tiles, so neighbours never cross groups.
    """

    mean: np.ndarray
    std: np.ndarray
    # group key -> (features (n, f), payloads list)
    groups: Dict[str, Tuple[np.ndarray, List[dict]]] = field(default_factory=dict)

    @staticmethod
    def group_key(executor: str, backend: str) -> str:
        return f"{executor}@{backend}"

    @classmethod
    def fit(cls, x: np.ndarray, keys: Sequence[str],
            payloads: Sequence[dict]) -> "NearestExample":
        mean = x.mean(axis=0)
        std = x.std(axis=0)
        xs = _standardize(x, mean, std)
        groups: Dict[str, Tuple[np.ndarray, List[dict]]] = {}
        for key in sorted(set(keys)):
            mask = np.asarray([k == key for k in keys])
            groups[key] = (xs[mask],
                           [p for k, p in zip(keys, payloads) if k == key])
        return cls(mean=mean, std=std, groups=groups)

    def predict(self, x: np.ndarray, executor: str,
                backend: str) -> Optional[dict]:
        entry = self.groups.get(self.group_key(executor, backend))
        if entry is None:
            return None
        feats, payloads = entry
        xs = _standardize(np.asarray(x, np.float64), self.mean, self.std)
        d = np.linalg.norm(feats - xs, axis=1)
        return dict(payloads[int(np.argmin(d))])

    def to_json(self) -> dict:
        return {
            "mean": self.mean.tolist(),
            "std": self.std.tolist(),
            "groups": {k: {"features": feats.tolist(), "payloads": payloads}
                       for k, (feats, payloads) in sorted(self.groups.items())},
        }

    @classmethod
    def from_json(cls, obj: Mapping) -> "NearestExample":
        groups = {}
        for key, entry in obj["groups"].items():
            groups[key] = (np.asarray(entry["features"], np.float64),
                           [dict(p) for p in entry["payloads"]])
        return cls(mean=np.asarray(obj["mean"], np.float64),
                   std=np.asarray(obj["std"], np.float64),
                   groups=groups)


@dataclass
class Predictor:
    """Trained selection model: format classifier + tune-param replayer.

    Either half may be None when the harvest had no examples for it (e.g.
    a cache full of heuristic FormatPlans but no searched TunePlans).
    """

    format_model: Optional[CentroidClassifier] = None
    tune_model: Optional[NearestExample] = None
    n_format_examples: int = 0
    n_tune_examples: int = 0

    def predict_format(self, stats: Mapping[str, float],
                       allowed: Sequence[str]) -> Optional[str]:
        if self.format_model is None:
            return None
        x = feature_vector(stats)
        if x is None:
            return None
        return self.format_model.predict(x, allowed=allowed)

    def predict_tune(self, stats: Mapping[str, float], executor: str,
                     backend: str) -> Optional[dict]:
        if self.tune_model is None:
            return None
        x = feature_vector(stats)
        if x is None:
            return None
        return self.tune_model.predict(x, executor=executor, backend=backend)

    def to_json(self) -> dict:
        return {
            "schema": FEATURE_SCHEMA,
            "feature_names": list(FEATURE_NAMES),
            "format_model": (self.format_model.to_json()
                             if self.format_model else None),
            "tune_model": (self.tune_model.to_json()
                           if self.tune_model else None),
            "n_format_examples": self.n_format_examples,
            "n_tune_examples": self.n_tune_examples,
        }

    @classmethod
    def from_json(cls, obj: Mapping) -> Optional["Predictor"]:
        """None (not an error) on schema mismatch: an old predictor must
        be retrained, never scored against reordered features."""
        if obj.get("schema") != FEATURE_SCHEMA:
            return None
        if tuple(obj.get("feature_names", ())) != FEATURE_NAMES:
            return None
        fm = obj.get("format_model")
        tm = obj.get("tune_model")
        return cls(
            format_model=CentroidClassifier.from_json(fm) if fm else None,
            tune_model=NearestExample.from_json(tm) if tm else None,
            n_format_examples=int(obj.get("n_format_examples", 0)),
            n_tune_examples=int(obj.get("n_tune_examples", 0)),
        )
