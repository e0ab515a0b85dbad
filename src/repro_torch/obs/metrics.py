"""Metrics registry: labeled counters, gauges and quantile histograms.

Torch counterpart of ``repro/obs/metrics.py``, stdlib only, with the same
two contracts:

* **Zero cost when off.**  Every mutating method starts with one
  ``SWITCH.on`` attribute check and returns at once while observability is
  disabled: no allocation, no arithmetic.  Instruments are fetched once
  (``registry.counter(...)`` memoizes on name + labels) and held by the
  instrumented object, so the hot path never touches the registry.

* **Identity-preserving reset.**  ``reset()`` zeroes values in place: a
  scheduler that cached its counter at construction keeps a live handle
  across resets.

Histograms keep ``count``/``sum``/``min``/``max`` exact and estimate
quantiles from a bounded reservoir (4096 samples by default): below the
cap the estimate is exact; past it samples are replaced uniformly at
random by a generator seeded from the instrument's name
(``random.Random(zlib.crc32(name))``), so the same observations give the
same snapshot here and in the reference.  :func:`quantile` is the one
interpolation rule (numpy's default ``linear``) the port shares.
"""
from __future__ import annotations

import math
import random
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs.runtime import SWITCH

LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]

#: quantiles serialized for every histogram in snapshot()
SNAPSHOT_QUANTILES = (50.0, 90.0, 95.0, 99.0)


def quantile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (q in [0, 100]) under linear interpolation —
    numerically identical to ``np.percentile(values, q)`` with the default
    method.  The single percentile implementation every consumer shares."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    xs = sorted(values)
    if not xs:
        return math.nan
    rank = (len(xs) - 1) * (q / 100.0)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    if lo == hi:
        return float(xs[lo])
    frac = rank - lo
    return float(xs[lo]) * (1.0 - frac) + float(xs[hi]) * frac


class Counter:
    """Monotonically increasing labeled counter."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not SWITCH.on:
            return
        self.value += n

    def _reset(self) -> None:
        self.value = 0.0


class Gauge:
    """Last-value-wins labeled gauge."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        if not SWITCH.on:
            return
        self.value = v

    def inc(self, n: float = 1.0) -> None:
        if not SWITCH.on:
            return
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        if not SWITCH.on:
            return
        self.value -= n

    def _reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Streaming distribution: exact moments + reservoir quantiles."""

    __slots__ = ("name", "labels", "count", "sum", "min", "max",
                 "_samples", "_cap", "_rng")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 max_samples: int = 4096):
        self.name = name
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: List[float] = []
        self._cap = max_samples
        # deterministic per-instrument stream: same trace -> same quantiles
        self._rng = random.Random(zlib.crc32(name.encode()))

    def observe(self, v: float) -> None:
        if not SWITCH.on:
            return
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._samples) < self._cap:
            self._samples.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self._cap:
                self._samples[j] = v

    def quantile(self, q: float) -> float:
        """Estimated q-th percentile (exact while count <= max_samples)."""
        return quantile(self._samples, q)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def _reset(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples.clear()


class MetricsRegistry:
    """Name + labels -> instrument, memoized; snapshot() serializes all.

    One process-global instance lives at ``repro_torch.obs.METRICS``;
    private registries are only for tests.
    """

    def __init__(self):
        self._counters: Dict[LabelKey, Counter] = {}
        self._gauges: Dict[LabelKey, Gauge] = {}
        self._histograms: Dict[LabelKey, Histogram] = {}

    @staticmethod
    def _key(name: str, labels: Dict[str, object]) -> LabelKey:
        return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))

    def counter(self, name: str, **labels) -> Counter:
        key = self._key(name, labels)
        inst = self._counters.get(key)
        if inst is None:
            inst = self._counters[key] = Counter(name, key[1])
        return inst

    def gauge(self, name: str, **labels) -> Gauge:
        key = self._key(name, labels)
        inst = self._gauges.get(key)
        if inst is None:
            inst = self._gauges[key] = Gauge(name, key[1])
        return inst

    def histogram(self, name: str, max_samples: int = 4096,
                  **labels) -> Histogram:
        key = self._key(name, labels)
        inst = self._histograms.get(key)
        if inst is None:
            inst = self._histograms[key] = Histogram(name, key[1],
                                                     max_samples)
        return inst

    # -- read side ---------------------------------------------------------
    def value(self, name: str, **labels) -> float:
        """Current value of a counter or gauge (counters win on a name
        collision; 0.0 when the instrument was never created)."""
        key = self._key(name, labels)
        if key in self._counters:
            return self._counters[key].value
        if key in self._gauges:
            return self._gauges[key].value
        return 0.0

    def total(self, name: str, **match) -> float:
        """Sum of every counter named ``name`` whose labels include all of
        ``match`` (e.g. all plan-cache hits across plan kinds)."""
        want = {(k, str(v)) for k, v in match.items()}
        return sum(c.value for (n, labels), c in self._counters.items()
                   if n == name and want <= set(labels))

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        """Zero every instrument in place — held references stay live."""
        for group in (self._counters, self._gauges, self._histograms):
            for inst in group.values():
                inst._reset()

    def snapshot(self) -> dict:
        """JSON-ready dump of every instrument.

        Histograms serialize their exact moments plus the
        :data:`SNAPSHOT_QUANTILES` estimates; empty histograms serialize
        with ``count = 0`` and no quantiles (NaN is not valid JSON)."""

        def _entry(inst) -> dict:
            return dict(name=inst.name, labels=dict(inst.labels))

        hists = []
        for h in self._histograms.values():
            e = _entry(h)
            e["count"] = h.count
            e["sum"] = h.sum
            if h.count:
                e["min"] = h.min
                e["max"] = h.max
                e["mean"] = h.mean
                e["quantiles"] = {f"p{q:g}": h.quantile(q)
                                  for q in SNAPSHOT_QUANTILES}
            hists.append(e)
        return dict(
            schema="obs-1",
            counters=[dict(_entry(c), value=c.value)
                      for c in self._counters.values()],
            gauges=[dict(_entry(g), value=g.value)
                    for g in self._gauges.values()],
            histograms=hists,
        )


def snapshot_value(snap: dict, kind: str, name: str,
                   labels: Optional[dict] = None) -> Optional[float]:
    """Look one counter/gauge value out of a serialized snapshot."""
    want = {k: str(v) for k, v in (labels or {}).items()}
    entries: Iterable[dict] = snap.get(kind, ())
    for e in entries:
        if e.get("name") == name and want.items() <= e.get("labels",
                                                           {}).items():
            return float(e["value"])
    return None
