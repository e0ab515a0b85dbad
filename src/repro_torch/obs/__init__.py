"""Observability: metrics and span tracing for the engines and the service.

Torch counterpart of ``repro/obs``.  One process-global
:class:`~repro_torch.obs.metrics.MetricsRegistry` and one
:class:`~repro_torch.obs.trace.Tracer`, off by default (``enable()`` or
``$REPRO_OBS=1`` arms them).  Disabled instrument calls are
allocation-free no-ops, so the scheduler, the plan cache, the tuner and
the engines' step loops are instrumented unconditionally.

Hot-path idiom: fetch instruments once, hold them, and guard any *extra*
work (clock reads, device events, byte counts) behind ``SWITCH.on``::

    from repro_torch import obs

    class Scheduler:
        def __init__(self):
            self._m_admitted = obs.counter("serve.jobs.admitted")

        def submit(self, job):
            self._m_admitted.inc()          # no-op when disabled

``snapshot()`` serializes every instrument into the reference's
``obs-1`` JSON structure, once the device timings the tracer holds are
resolved (:mod:`repro_torch.obs.step`).
"""
from __future__ import annotations

from repro_torch.obs.metrics import (MetricsRegistry, quantile,  # noqa: F401
                                     snapshot_value)
from repro_torch.obs.runtime import (SWITCH, disable, enable,  # noqa: F401
                                     enabled)
from repro_torch.obs.step import timed_step  # noqa: F401
from repro_torch.obs.trace import Tracer  # noqa: F401

#: process-global instances: the ones the port instruments
METRICS = MetricsRegistry()
TRACER = Tracer()

# bound convenience accessors: obs.counter(...) etc.
counter = METRICS.counter
gauge = METRICS.gauge
histogram = METRICS.histogram
value = METRICS.value
total = METRICS.total
span = TRACER.span
timed = TRACER.timed


def record_cache_stats(stats, prefix: str = "plan_cache") -> None:
    """Mirror a :class:`~repro_torch.core.plan_cache.CacheStats` into
    gauges.

    The stats object counts every lookup since the cache was built,
    including ones made while observability was disabled, so the service
    surfaces it as authoritative gauges at snapshot time rather than
    relying on the live lookup counters alone."""
    METRICS.gauge(f"{prefix}.hits").set(float(stats.hits))
    METRICS.gauge(f"{prefix}.misses").set(float(stats.misses))
    METRICS.gauge(f"{prefix}.hit_rate").set(float(stats.hit_rate))


def snapshot() -> dict:
    """Serialize every metric (and the trace's accounting) to a JSON-ready
    dict, after resolving the held device timings (this may wait for the
    card)."""
    TRACER.flush()
    snap = METRICS.snapshot()
    snap["spans"] = dict(recorded=sum(1 for _ in _iter_spans()),
                         roots=len(TRACER.roots), dropped=TRACER.dropped)
    return snap


def _iter_spans():
    stack = list(TRACER.roots)
    while stack:
        s = stack.pop()
        stack.extend(s.children)
        yield s


def reset() -> None:
    """Zero every metric in place and drop all recorded spans."""
    METRICS.reset()
    TRACER.reset()
