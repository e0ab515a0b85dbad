"""Context-manager span tracing with Chrome-trace export.

Torch counterpart of ``repro/obs/trace.py``.  A span is a named,
attributed interval on the monotonic clock (``time.monotonic_ns``).
Nesting follows ``with`` structure: the tracer keeps an open stack, a span
entered while another is open becomes its child, and the roots form the
trace.  The taxonomy is the reference's (``scheduler.tick`` >
``scheduler.slice`` > ``engine.step``; ``service.checkpoint``;
``tune.search``; ``scheduler.quarantine``).

A span reads the host clock.  Kernels launch asynchronously, so an
instrumented caller that wants the span to cover device work fences it
itself before the span closes (``engine.step`` synchronizes the card
while observability is on).

Disabled-path contract: ``Tracer.span()`` returns a shared no-op context
manager while the switch is off, so no span object is allocated.
Attributes are passed as an optional dict argument
(``span("engine.step", {"k": 8})``), not as ``**kwargs``, so a disabled
call site builds no dict.

Export is Chrome-trace JSON (``chrome://tracing`` / Perfetto complete
events): timestamps and durations in microseconds, attributes in
``args``.  Past ``max_spans`` recorded spans, new spans are counted in
``dropped`` instead of stored.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

from repro_torch.obs.runtime import SWITCH


class Span:
    """One timed interval; a context manager bound to its tracer."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "children",
                 "_tracer")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Optional[Dict[str, object]] = None):
        self.name = name
        self.attrs: Dict[str, object] = {} if attrs is None else dict(attrs)
        self.start_ns = 0
        self.end_ns = 0
        self.children: List[Span] = []
        self._tracer = tracer

    def set_attr(self, key: str, value: object) -> None:
        """Attach a result computed inside the span (e.g. achieved GB/s)."""
        self.attrs[key] = value

    @property
    def duration_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.monotonic_ns()
        self._tracer._pop(self)

    def as_dict(self) -> dict:
        return dict(name=self.name, attrs=dict(self.attrs),
                    start_us=self.start_ns / 1e3,
                    dur_us=(self.end_ns - self.start_ns) / 1e3,
                    children=[c.as_dict() for c in self.children])


class _NoopSpan:
    """Shared disabled-path span: allocation-free enter/exit/set_attr."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set_attr(self, key, value):
        return None


_NOOP_SPAN = _NoopSpan()


class Tracer:
    """Span factory + the open-span stack + the finished-span forest."""

    def __init__(self, max_spans: int = 100_000):
        self.roots: List[Span] = []
        self.dropped = 0
        self.max_spans = max_spans
        self._stack: List[Span] = []
        self._recorded = 0

    def span(self, name: str,
             attrs: Optional[Dict[str, object]] = None):
        """Open a span: ``with tracer.span("engine.step", {"k": 8}):``.

        Returns the shared no-op context manager when observability is
        disabled."""
        if not SWITCH.on:
            return _NOOP_SPAN
        return Span(self, name, attrs)

    # -- stack maintenance (called by Span.__enter__/__exit__) -------------
    def _push(self, span: Span) -> None:
        self._stack.append(span)

    def _pop(self, span: Span) -> None:
        # tolerate interleaved exits (generators, exceptions): unwind to
        # the span being closed rather than assuming strict LIFO
        while self._stack:
            top = self._stack.pop()
            if top is span:
                break
        if self._recorded >= self.max_spans:
            self.dropped += 1
            return
        if self._stack:
            self._stack[-1].children.append(span)
        else:
            self.roots.append(span)
        self._recorded += 1

    # -- export ------------------------------------------------------------
    def export(self) -> List[dict]:
        """Structured (nested) dump of every finished root span."""
        return [s.as_dict() for s in self.roots]

    def export_chrome(self) -> List[dict]:
        """Flat Chrome-trace complete events (``ph: "X"``, microseconds)."""
        events: List[dict] = []

        def walk(span: Span) -> None:
            events.append(dict(
                name=span.name, ph="X", pid=0, tid=0,
                ts=span.start_ns / 1e3,
                dur=(span.end_ns - span.start_ns) / 1e3,
                args=dict(span.attrs)))
            for c in span.children:
                walk(c)

        for root in self.roots:
            walk(root)
        return events

    def to_chrome_json(self) -> str:
        return json.dumps({"traceEvents": self.export_chrome()})

    def reset(self) -> None:
        self.roots.clear()
        self._stack.clear()
        self.dropped = 0
        self._recorded = 0
