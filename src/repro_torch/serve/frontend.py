"""Async serving front line: submission, streaming results, backpressure.

Torch counterpart of ``repro/serve/frontend.py``.  :class:`LifeFrontend`
is the traffic-facing layer over
:class:`~repro_torch.serve.service.LifeService`.  The service
and its scheduler are deliberately single-threaded — engines, plan cache
and checkpointing all assume one driver — so the frontend gives them one:
a background *driver thread* owns the tick loop exclusively, and every
other thread talks to it through two small synchronized structures:

* the **admission queue** — a bounded deque of not-yet-submitted
  :class:`JobHandle` specs.  ``submit_async()`` appends under the
  frontend lock and returns immediately; the driver drains it into
  ``LifeService.submit`` between ticks.  The bound is the backpressure
  point: when the queue is full the configured policy decides
  whether the caller blocks, is rejected with
  :class:`AdmissionQueueFull`, or a lower-priority pending job is shed
  to make room.
* the **command queue** — cancellation requests for jobs that already
  crossed into the service.  Cancelling a *pending* handle never touches
  the driver at all.

Results stream back through the handle: ``JobHandle.result(timeout)``
blocks on a ``threading.Event`` the driver sets at terminal state and
returns ``(weights, loss trace)`` as torch tensors on the service's device
(the reference returns a JAX array and a numpy trace);
``JobHandle.events()`` yields per-slice progress events (iterations done,
latest loss) the driver publishes after every tick.  A failed job's
captured executor exception — the scheduler's failure-isolation machinery
guarantees one bad tenant fails alone — surfaces on the handle:
``result()`` raises :class:`~repro_torch.serve.scheduler.JobFailedError`
chaining it, ``exception()`` returns it.  An exception that escapes the
driver's own loop (a service or card fault, not one tenant's) stops the
driver: every handle it holds resolves as failed with that exception,
later submissions raise, and :meth:`LifeFrontend.shutdown` re-raises it.

On the card the driver thread launches the kernels on its own current
stream (the default stream); the kernel libraries it shares with other
threads are loaded under a lock (``repro_torch.kernels._build``).

Shutdown is graceful by default: ``shutdown()`` (or leaving the
``with`` block) stops admission, drains every in-flight solve, writes a
final checkpoint, and joins the driver.  ``shutdown(drain=False)`` stops
after the current tick instead — in-flight states still hit the final
checkpoint, and handles that never completed resolve with
:class:`ShutdownError` rather than hanging their waiters.
"""
from __future__ import annotations

import collections
import threading
from typing import Deque, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core.life import LifeConfig
from repro_torch.learn.refine import QUEUE as refine_queue
from repro_torch.serve.scheduler import (JobCancelledError, JobFailedError,
                                         TERMINAL_STATUSES)
from repro_torch.serve.service import LifeService

#: admission-queue-full policies
BACKPRESSURE_POLICIES = ("block", "reject", "shed")

#: terminal handle states (superset of the scheduler's: admission-time
#: rejections and shutdown produce terminal handles the scheduler never saw)
_HANDLE_TERMINAL = TERMINAL_STATUSES + ("shed", "rejected")


class AdmissionQueueFull(RuntimeError):
    """The bounded admission queue rejected a submission (policy
    "reject", a shed that picked the submitting job itself as the
    lowest-priority victim, or a "block" that timed out)."""


class ShutdownError(RuntimeError):
    """The frontend shut down before this job reached a terminal state."""


class JobHandle:
    """Future-like handle for one async submission.

    Created by :meth:`LifeFrontend.submit_async`; resolved by the driver
    thread.  All methods are safe to call from any thread."""

    def __init__(self, frontend: "LifeFrontend", problem, kwargs: dict):
        self._frontend = frontend
        self._problem = problem
        self._kwargs = kwargs
        self.job_id: Optional[str] = kwargs.get("job_id")
        self.priority = int(kwargs.get("priority") or 0)
        self._status = "pending"          # pending until the driver admits
        self._result: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._error: Optional[BaseException] = None
        self._terminal = threading.Event()
        self._events: "collections.deque[dict]" = collections.deque()
        self._events_ready = threading.Condition(threading.Lock())
        self._last_done = -1

    # -- read side (any thread) --------------------------------------------
    def status(self) -> str:
        """pending | queued | running | done | failed | cancelled | shed |
        rejected ("pending" = still in the admission queue)."""
        return self._status

    def done(self) -> bool:
        """True once the job reached any terminal state."""
        return self._terminal.is_set()

    def result(self, timeout: Optional[float] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Block until terminal; returns (weights, loss trace), tensors on
        the service's device.  Raises
        :class:`~repro_torch.serve.scheduler.JobFailedError` (chaining the
        executor's exception) when the solve failed, TimeoutError when
        ``timeout`` elapses first."""
        if not self._terminal.wait(timeout):
            raise TimeoutError(
                f"job {self.job_id or '<pending>'} not finished "
                f"within {timeout}s")
        if self._error is not None:
            if isinstance(self._error, (JobFailedError, JobCancelledError,
                                        AdmissionQueueFull, ShutdownError)):
                raise self._error
            raise JobFailedError(self.job_id or "<pending>",
                                 self._error) from self._error
        assert self._result is not None
        return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        """Block until terminal; the failure (or None on success)."""
        if not self._terminal.wait(timeout):
            raise TimeoutError(
                f"job {self.job_id or '<pending>'} not finished "
                f"within {timeout}s")
        return self._error

    def events(self, timeout: Optional[float] = None) -> Iterator[dict]:
        """Yield progress events until the job is terminal.

        Each event is a dict: ``{"type": "progress", "done": k,
        "n_iters": n, "loss": latest}`` per served slice, closed by one
        ``{"type": <terminal status>}`` event.  ``timeout`` bounds the
        wait for *each* event (TimeoutError on expiry)."""
        while True:
            with self._events_ready:
                while not self._events:
                    if not self._events_ready.wait(timeout):
                        raise TimeoutError(
                            f"no event from job "
                            f"{self.job_id or '<pending>'} "
                            f"within {timeout}s")
                event = self._events.popleft()
            yield event
            if event["type"] != "progress":
                return

    def cancel(self) -> bool:
        """Request cancellation; True if the request was accepted (the
        job was still pending, queued, or running)."""
        return self._frontend._cancel(self)

    # -- write side (driver thread / admission path) -----------------------
    def _publish(self, event: dict) -> None:
        with self._events_ready:
            self._events.append(event)
            self._events_ready.notify_all()

    def _resolve(self, status: str,
                 result: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 error: Optional[BaseException] = None) -> None:
        self._status = status
        self._result = result
        self._error = error
        self._publish({"type": status})
        self._terminal.set()


class LifeFrontend:
    """Async, failure-isolated submission layer over one LifeService.

    ::

        with LifeFrontend(config, max_queue=64,
                          backpressure="block") as fe:
            h = fe.submit_async(problem, n_iters=500, priority=5)
            for ev in h.events():
                print(ev)                      # per-slice progress
            w, losses = h.result(timeout=600)
        # leaving the block drains, final-checkpoints, stops the driver

    Parameters
    ----------
    config / service_kwargs:
        Forwarded to :class:`LifeService` — or pass a prebuilt
        ``service=`` instead (the frontend takes exclusive ownership: no
        other thread may drive it once the frontend starts).
    max_queue:
        Bound of the admission queue (pending submissions the driver has
        not yet accepted).  Jobs already inside the service do not count:
        the scheduler's own queue is drained every tick by design.
    backpressure:
        "block" (default) — ``submit_async`` waits for space (honoring
        its ``timeout``); "reject" — raise :class:`AdmissionQueueFull`
        immediately; "shed" — evict the lowest-priority pending job to
        make room (the new job itself is rejected if nothing pending has
        lower priority).
    refine:
        True (default) — while the driver is otherwise idle (no pending
        submissions, no commands, no active jobs) it drains one task per
        tick from the learn subsystem's background-refinement queue
        (:data:`repro_torch.learn.refine.QUEUE`), upgrading zero-measurement
        ``reason="predicted"`` plans to measured ones without ever
        competing with real work.  False disables the hook.
    """

    def __init__(self, config: Optional[LifeConfig] = None, *,
                 service: Optional[LifeService] = None,
                 max_queue: int = 64, backpressure: str = "block",
                 idle_wait: float = 0.002, start: bool = True,
                 refine: bool = True,
                 **service_kwargs):
        if backpressure not in BACKPRESSURE_POLICIES:
            raise ValueError(f"backpressure must be one of "
                             f"{BACKPRESSURE_POLICIES}, got {backpressure!r}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if service is not None and (config is not None or service_kwargs):
            raise ValueError("pass either a prebuilt service= or "
                             "config/service kwargs, not both")
        self.service = (service if service is not None
                        else LifeService(config, **service_kwargs))
        self.max_queue = max_queue
        self.backpressure = backpressure
        self._idle_wait = idle_wait
        self._refine = refine
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)   # admission has room
        self._work = threading.Condition(self._lock)    # driver has work
        self._pending: Deque[JobHandle] = collections.deque()
        self._commands: List[Tuple[str, JobHandle]] = []
        self._live: Dict[str, JobHandle] = {}   # job_id -> handle (driver)
        self._closed = False                    # no further submissions
        self._drain = True                      # finish in-flight on stop
        self._driver: Optional[threading.Thread] = None
        #: the exception that stopped the driver thread, if one did
        self.driver_error: Optional[BaseException] = None
        # obs instruments (no-ops while disabled, DESIGN.md §12.2)
        self._g_admission = obs.gauge("serve.admission.depth")
        self._m_rejected = obs.counter("serve.admission.rejected")
        self._m_shed = obs.counter("serve.admission.shed")
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Start the driver thread (idempotent)."""
        if self._driver is not None:
            return
        self._driver = threading.Thread(target=self._drive,
                                        name="life-frontend-driver",
                                        daemon=True)
        self._driver.start()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop accepting work and stop the driver.

        ``drain=True`` (default) finishes every in-flight and pending
        job first; ``drain=False`` stops after the current tick and
        resolves unfinished handles with :class:`ShutdownError`.  Either
        way the service writes a final checkpoint before the driver
        exits, so ``drain=False`` loses no solver state — a restarted
        service re-adopts every interrupted job.

        Raises:
            TimeoutError: the driver did not stop within ``timeout``.
            RuntimeError: the driver thread had stopped on an exception
                (chained); its handles resolved as failed."""
        with self._lock:
            self._closed = True
            self._drain = drain
            self._work.notify_all()
            self._space.notify_all()      # unblock waiting submitters
        if self._driver is not None:
            self._driver.join(timeout)
            if self._driver.is_alive():
                raise TimeoutError(f"driver did not stop within {timeout}s")
            self._driver = None
        if self.driver_error is not None:
            raise RuntimeError("the frontend's driver thread failed") \
                from self.driver_error

    def __enter__(self) -> "LifeFrontend":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)

    # -- intake (any thread) -----------------------------------------------
    def submit_async(self, problem, *, timeout: Optional[float] = None,
                     **submit_kwargs) -> JobHandle:
        """Queue one solve for async execution; returns its handle.

        Args:
            problem: the :class:`~repro_torch.data.dmri.LifeProblem` to
                solve.
            timeout: bound on the wait for admission-queue space under
                the "block" backpressure policy.
            **submit_kwargs: mirror
                :meth:`~repro_torch.serve.service.LifeService.submit` —
                job_id, n_iters, priority, deadline, format, mesh,
                tune, compute_dtype, and ``w0`` (warm-start weights for
                repeat-visit jobs).

        Returns:
            A :class:`JobHandle`.  Admission-time validation errors
            (unknown format, bad mesh, digest-mismatched resume, bad
            ``w0``) do not raise here — they resolve the handle as
            "rejected", like any other per-job failure.

        Raises:
            AdmissionQueueFull: under the "reject" policy, or when a
                "block" wait exceeds ``timeout``.
            RuntimeError: when the frontend is already shut down, or its
                driver thread stopped on an exception."""
        handle = JobHandle(self, problem, submit_kwargs)
        with self._lock:
            if self.driver_error is not None:
                raise RuntimeError("the frontend's driver thread failed") \
                    from self.driver_error
            if self._closed:
                raise RuntimeError("frontend is shut down")
            if len(self._pending) >= self.max_queue:
                self._backpressure(handle, timeout)
                if handle.done():             # shed picked the newcomer
                    return handle
            self._pending.append(handle)
            self._g_admission.set(float(len(self._pending)))
            self._work.notify_all()
        return handle

    def _backpressure(self, handle: JobHandle,
                      timeout: Optional[float]) -> None:
        """Make room for ``handle`` per the configured policy (called
        under the lock with the admission queue full)."""
        if self.backpressure == "reject":
            self._m_rejected.inc()
            raise AdmissionQueueFull(
                f"admission queue full ({self.max_queue} pending)")
        if self.backpressure == "shed":
            victim = min(self._pending, key=lambda h: h.priority)
            if victim.priority >= handle.priority:
                # the newcomer is itself the lowest priority: shed it —
                # resolved on the handle, not raised, so open-loop
                # producers can keep submitting without try/except
                self._m_shed.inc()
                handle._resolve("shed", error=AdmissionQueueFull(
                    "shed: admission queue full of higher-priority work"))
                return
            self._pending.remove(victim)
            self._m_shed.inc()
            victim._resolve("shed", error=AdmissionQueueFull(
                f"shed by higher-priority arrival "
                f"(priority {handle.priority} > {victim.priority})"))
            return
        # "block": wait for the driver to drain below the bound
        if not self._space.wait_for(
                lambda: len(self._pending) < self.max_queue or self._closed,
                timeout=timeout):
            self._m_rejected.inc()
            raise AdmissionQueueFull(
                f"admission queue still full after {timeout}s")
        if self._closed:
            raise RuntimeError("frontend shut down while blocked on "
                               "admission")

    def _cancel(self, handle: JobHandle) -> bool:
        with self._lock:
            if handle.done():
                return False
            if handle._status == "pending":
                try:
                    self._pending.remove(handle)
                except ValueError:
                    pass                      # driver grabbed it just now
                else:
                    self._g_admission.set(float(len(self._pending)))
                    self._space.notify_all()
                    handle._resolve("cancelled",
                                    error=JobCancelledError(
                                        handle.job_id or "<pending>"))
                    return True
            self._commands.append(("cancel", handle))
            self._work.notify_all()
        return True

    # -- the driver thread -------------------------------------------------
    def _drive(self) -> None:
        try:
            self._loop()
        except Exception as exc:
            # the boundary of the driver thread: the failure is reported on
            # every handle it holds and re-raised by shutdown()
            self._fail_all(exc)
            return
        # final checkpoint: even a drain=False stop leaves every solver
        # state durable for the resume path
        self.service.checkpoint()
        if not self._drain:
            with self._lock:
                pending = list(self._pending)
                self._pending.clear()
                live = list(self._live.values())
                self._live.clear()
                self._g_admission.set(0.0)
            for h in pending + live:
                if not h.done():
                    h._resolve("failed", error=ShutdownError(
                        f"frontend shut down before job "
                        f"{h.job_id or '<pending>'} finished"))

    def _fail_all(self, exc: BaseException) -> None:
        """The driver loop raised: stop intake and resolve every handle
        the driver holds as failed with ``exc``."""
        with self._lock:
            self.driver_error = exc
            self._closed = True
            pending = list(self._pending)
            self._pending.clear()
            live = list(self._live.values())
            self._live.clear()
            self._g_admission.set(0.0)
            self._space.notify_all()
        for h in pending + live:
            if not h.done():
                h._resolve("failed", error=exc)

    def _loop(self) -> None:
        while True:
            with self._lock:
                stop = self._closed and not (
                    self._drain and (self._pending or self._commands
                                     or self._live
                                     or self.service.scheduler.active()))
                if stop:
                    break
                if not (self._pending or self._commands
                        or self.service.scheduler.active()):
                    if not (self._refine and len(refine_queue)):
                        self._work.wait(self._idle_wait)
                        continue
                    # fall through (lock released below) to spend the idle
                    # tick on one background-refinement task
                    idle_refine = True
                else:
                    idle_refine = False
            if idle_refine:
                # outside the lock: a measured refinement must never block
                # submit_async/cancel; one task per tick keeps the driver
                # responsive — new work is re-checked before the next task
                refine_queue.run_one()
                continue
            self._admit()
            self._run_commands()
            if self.service.scheduler.active():
                self.service.step()
            self._sync()

    def _admit(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    return
                handle = self._pending.popleft()
                self._g_admission.set(float(len(self._pending)))
                self._space.notify_all()
            try:
                jid = self.service.submit(handle._problem, **handle._kwargs)
            except Exception as exc:
                # submission-time validation failure: isolated to this
                # handle, admission keeps flowing
                handle._resolve("rejected", error=exc)
            else:
                handle.job_id = jid
                handle._status = self.service.status(jid)
                self._live[jid] = handle

    def _run_commands(self) -> None:
        with self._lock:
            commands, self._commands = self._commands, []
        for op, handle in commands:
            if op == "cancel" and handle.job_id is not None \
                    and not handle.done():
                self.service.cancel(handle.job_id)

    def _sync(self) -> None:
        """Publish progress and resolve terminal jobs after a tick."""
        for jid, handle in list(self._live.items()):
            job = self.service.job(jid)
            if job.done != handle._last_done and job.losses:
                handle._last_done = job.done
                handle._publish({"type": "progress", "done": job.done,
                                 "n_iters": job.n_iters,
                                 "loss": float(job.losses[-1].reshape(-1)[-1])})
            if job.status not in TERMINAL_STATUSES:
                handle._status = job.status
                continue
            del self._live[jid]
            if job.status == "done":
                handle._resolve("done", result=job.result())
            elif job.status == "cancelled":
                handle._resolve("cancelled",
                                error=JobCancelledError(jid))
            else:
                assert job.error is not None
                handle._resolve("failed",
                                error=JobFailedError(jid, job.error))
