"""Background refinement queue: measured autotune demoted to spare cycles.

Torch counterpart of ``repro/learn/refine.py``, with the port's own
process-global :data:`QUEUE`.  A refinement task times the card's kernels,
so it runs on whichever thread drains it (the front line's driver thread,
:mod:`repro_torch.serve.frontend`), on that thread's current stream.

The predicted cold-start path answers a cache miss with zero measurements;
the measurements still happen, just not on the critical path.  When a
selector or tuner serves a ``reason="predicted"`` plan it enqueues a
refinement task here, and the serve frontend's driver thread drains one
task per idle tick (``LifeFrontend._drive`` in
:mod:`repro_torch.serve.frontend`: only when no job is pending,
admitted, or active — refinement never competes with real work).  Each
task re-runs the *measured* pipeline and overwrites the plan-cache entry
in place, so the next engine rebuild replays a searched plan and the next
``train_predictor`` harvest gains a measured example.

The queue is deliberately dumb: bounded, deduplicated by ``(kind, key)``,
tasks are plain closures, and a task that raises is counted and dropped —
a refinement failure must never take down the driver thread that hosts it.
Anything (a test, a CLI, a cron job) may also drain it synchronously via
:func:`run_pending`.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional, Set, Tuple

from repro_torch import obs

DEFAULT_MAX_TASKS = 256


class RefineQueue:
    """Bounded, deduplicating FIFO of refinement closures."""

    def __init__(self, max_tasks: int = DEFAULT_MAX_TASKS):
        self.max_tasks = max_tasks
        self._lock = threading.Lock()
        self._tasks: List[Tuple[Tuple[str, str], Callable[[], None]]] = []
        self._keys: Set[Tuple[str, str]] = set()
        #: the exception of the last task that raised (None if none has)
        self.last_error: Optional[BaseException] = None

    def push(self, kind: str, key: str, fn: Callable[[], None]) -> bool:
        """Enqueue ``fn`` under identity ``(kind, key)``.  Returns False
        (and drops) when the identity is already queued or the queue is
        full — re-predicting the same dataset must not duplicate work."""
        ident = (kind, key)
        with self._lock:
            if ident in self._keys or len(self._tasks) >= self.max_tasks:
                return False
            self._tasks.append((ident, fn))
            self._keys.add(ident)
        obs.counter("learn.refine.queued", kind=kind).inc()
        return True

    def run_one(self) -> bool:
        """Pop and run the oldest task; True if one ran (even if it failed)."""
        with self._lock:
            if not self._tasks:
                return False
            ident, fn = self._tasks.pop(0)
            self._keys.discard(ident)
        try:
            fn()
            obs.counter("learn.refine.completed", kind=ident[0]).inc()
        except Exception as exc:
            # refinement is best-effort by design: the predicted plan keeps
            # serving and the task is dropped, not retried in a hot loop;
            # the failure is counted and kept for the caller to read
            self.last_error = exc
            obs.counter("learn.refine.failed", kind=ident[0]).inc()
        return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._tasks)

    def clear(self) -> None:
        with self._lock:
            self._tasks.clear()
            self._keys.clear()


#: process-global queue the selector/tuner push to and the frontend drains
QUEUE = RefineQueue()


def run_pending(limit: Optional[int] = None) -> int:
    """Synchronously drain up to ``limit`` tasks (all, when None)."""
    n = 0
    while (limit is None or n < limit) and QUEUE.run_one():
        n += 1
    return n
