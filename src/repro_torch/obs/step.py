"""The engines' ``engine.step`` span, timed on the device without a fence.

Both engines step through :func:`timed_step` while observability is on
(their disabled path calls the solver directly).  On a CUDA device the
step's launches sit between a pair of CUDA events recorded on the current
stream, and nothing waits for the card: the pair goes to
:meth:`~repro_torch.obs.trace.Tracer.defer` and is resolved at a later
step once the card has passed it (after that step's launches), or at
``Tracer.export()`` / ``obs.snapshot()``, which wait for it.  On the CPU the host clock around
the step is the device's, and the step resolves at once.

Resolving observes the device seconds in the step's histogram, sets the
span's ``device_s`` attribute and hands both to the engine's
``annotate(span, seconds)`` (the roofline gauges).  A resolved pair's
events go back to a pool and are recorded again by a later step:
creating two events costs the step's prologue as much again as recording
them, and the card may be waiting for that prologue's launches.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.obs.metrics import Histogram

Annotate = Callable[[object, float], None]

#: resolved (start, end) event pairs by device index, for later steps
_IDLE: Dict[int, List[tuple]] = collections.defaultdict(list)


class _EventPair:
    """One step's CUDA events, held by the tracer until resolved."""

    __slots__ = ("start", "end", "done", "device")

    def __init__(self, start, end, done: Callable[[float], None],
                 device: int):
        self.start, self.end, self.done = start, end, done
        self.device = device

    def ready(self) -> bool:
        return self.end.query()

    def resolve(self) -> None:
        self.end.synchronize()
        self.done(self.start.elapsed_time(self.end) / 1e3)
        _IDLE[self.device].append((self.start, self.end))


@contextlib.contextmanager
def timed_step(device: torch.device, attrs: Dict[str, object],
               histogram: Histogram, annotate: Optional[Annotate] = None):
    """``with timed_step(device, attrs, hist):`` around one step's launches
    (observability on): an ``engine.step`` span whose device seconds feed
    ``histogram`` and ``annotate`` when they are known."""
    from repro_torch import obs

    with obs.TRACER.span("engine.step", attrs) as sp:
        def done(seconds: float) -> None:
            sp.set_attr("device_s", seconds)
            histogram.observe(seconds)
            if annotate is not None:
                annotate(sp, seconds)

        if device.type != "cuda":
            t0 = time.perf_counter()
            yield sp
            done(time.perf_counter() - t0)
            return
        stream = torch.cuda.current_stream(device)
        idle = _IDLE[stream.device_index]
        if idle:
            start, end = idle.pop()
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield sp
        end.record(stream)
        # earlier steps resolve after this one's launches, which they
        # would otherwise hold back on a card waiting for work
        obs.TRACER.poll()
        obs.TRACER.defer(_EventPair(start, end, done, stream.device_index))
