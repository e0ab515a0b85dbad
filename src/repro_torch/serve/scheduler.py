"""Job queue and micro-batch scheduler for multi-tenant LiFE solves.

Torch counterpart of ``repro/serve/scheduler.py``.  SBBNNLS solves run for
hundreds of iterations and subjects arrive continuously, so the scheduler
(a) groups compatible subjects into one cohort solve, (b) admits late
arrivals without restarting anyone, and (c) shares the card fairly between
tenants with different priorities and deadlines.  All three reduce to the
stepped solver API (:func:`repro_torch.core.sbbnnls.sbbnnls_steps`): state
in, ``k`` iterations, state out, with the Barzilai-Borwein parity riding
in the state, so slicing and re-batching never change the trajectory.

Bucketing
---------
A job lands in the bucket keyed by its batch-compatibility class, the
reference's key tuple:

  (Nv, Nf, Ntheta, dictionary digest, format, mesh, tune mode,
   compute dtype, job id for a solo job)

Jobs asking for a stackable format (``BATCHABLE_FORMATS``: coo, alto, or
"auto", which resolves inside the cohort engine) share one
:class:`~repro_torch.core.batched.BatchedLifeEngine`.  SELL and F-COO
layouts are per-subject shapes that do not stack, so ``format="sell"`` and
``format="fcoo"`` jobs, and mesh jobs, get solo buckets running a
:class:`~repro_torch.core.life.LifeEngine` (kernels B3/B4 and B5/B6 on
the card) behind the same stepped interface.

Continuous batching
-------------------
Bucket membership is re-evaluated every tick: queued arrivals are
admitted, finished jobs leave, and the bucket engine is rebuilt only when
the member set changed.  Every inspector product a rebuild needs is
content-addressed in the shared
:class:`~repro_torch.core.plan_cache.PlanCache`, so re-batching the same
datasets hits the cache.  Solver states carry over verbatim.  Each job
keeps its own state between slices; a cohort slice stacks the members'
weights and losses with ``torch.stack`` and their iteration counters into
a host int32 array (the port's cohort solver keeps ``it`` on the host),
and hands each job back its row with ``it`` as a host int.

Time-slicing
------------
Each ``tick()`` serves the most urgent bucket for at most ``slice_iters``
iterations: earliest deadline first, then highest priority, then the
bucket served least, then the earliest arrival.

A slice that raises never propagates: the bucket is quarantined and each
member retried alone, so one bad tenant fails alone.

Mesh slices
-----------
A job may request a mesh slice (``Job.mesh = (R, C)``): its solve runs on
its format's mesh executor, found from the registry's ``mesh=`` /
``consumes=`` metadata (``shard`` for coo, ``shard-sell`` for sell), on a
local mesh rooted at the scheduler's device.  Mesh jobs name their cell
format: ``format="auto"`` would make the topology depend on a selection
intake never ran, so it is refused at submit, as are alto and fcoo (no
mesh executor), a non-positive shape and more cells than the device admits
(:func:`repro_torch.distributed.mesh.max_cells`: the visible cards, or
eight cells sharing the CPU).  Mesh jobs get solo buckets keyed by their
topology, and the bucket's engine config carries ``shard_rows`` /
``shard_cols``, so plan-cache keys (mesh shape, backend, device count) hit
on re-buckets of the same topology.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.bridge import to_numpy
from repro_torch.core.batched import BatchedLifeEngine
from repro_torch.core.life import LifeConfig, LifeEngine
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.registry import REGISTRY
from repro_torch.core.sbbnnls import SbbnnlsState, sbbnnls_init
from repro_torch.data.dmri import LifeProblem
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.mesh import max_cells

#: formats whose operands stack across subjects: eligible for shared
#: micro-batch buckets ("auto" restricts itself to the stackable subset
#: inside BatchedLifeEngine)
BATCHABLE_FORMATS = ("auto", "coo", "alto")

_SOLO_FORMATS = ("sell", "fcoo")


def _is_solo(fmt: str, mesh: Optional[Tuple[int, int]]) -> bool:
    """Solo-bucket predicate: SELL and F-COO operands do not stack, and a
    mesh slice is a per-job placement; either way the job never shares an
    engine.  One definition for the bucket key and the bucket."""
    return fmt in _SOLO_FORMATS or mesh is not None

#: statuses a job never leaves
TERMINAL_STATUSES = ("done", "failed", "cancelled")


class JobFailedError(RuntimeError):
    """Raised when a result is read off a job whose solve failed.

    The executor's exception is both chained (``__cause__``) and carried on
    ``.error``."""

    def __init__(self, job_id: str, error: BaseException):
        super().__init__(f"job {job_id!r} failed: {error!r}")
        self.job_id = job_id
        self.error = error


class JobCancelledError(RuntimeError):
    """Raised when a result is read off a cancelled job."""

    def __init__(self, job_id: str):
        super().__init__(f"job {job_id!r} was cancelled")
        self.job_id = job_id


def dataset_key(problem: LifeProblem) -> str:
    """Content digest of one subject's dataset (Phi, signal, dictionary).

    The reference's digest over the same bytes: the sizes and index arrays
    as int64, the values, signal and dictionary as float64, each cast on
    the host.  So a checkpoint written by either package's service
    resumes in the other, and byte-identical data shares the digest.
    """
    h = hashlib.sha256()
    phi = problem.phi
    h.update(np.int64([phi.n_atoms, phi.n_voxels, phi.n_fibers]).tobytes())
    for t in (phi.atoms, phi.voxels, phi.fibers):
        h.update(np.ascontiguousarray(to_numpy(t), np.int64).tobytes())
    for t in (phi.values, problem.b, problem.dictionary):
        h.update(np.ascontiguousarray(to_numpy(t), np.float64).tobytes())
    return h.hexdigest()[:16]


def _dict_digest(problem: LifeProblem) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(to_numpy(problem.dictionary),
                             np.float64).tobytes()).hexdigest()[:16]


@dataclasses.dataclass
class Job:
    """One tenant's solve request plus its in-flight progress."""

    job_id: str
    problem: LifeProblem
    n_iters: int
    priority: int = 0                     # higher runs sooner (tie-break)
    deadline: Optional[float] = None      # absolute time.monotonic() seconds
    format: str = "auto"
    # (R, C) mesh slice request; None = single-device engines
    mesh: Optional[Tuple[int, int]] = None
    # tuning knobs (None = inherit the scheduler config at submit); both
    # are part of the batch-compatibility class
    tune: Optional[str] = None            # "off" | "cached" | "full"
    compute_dtype: Optional[str] = None   # "fp32" | "bf16" | "auto"
    # warm-start weights (Nf,): the solver starts from sbbnnls_init(w0)
    # instead of all-ones; not part of the batch-compatibility class
    w0: Optional[np.ndarray] = None
    # None = unset (stamped at submit); 0.0 is a legitimate monotonic time
    submitted_at: Optional[float] = None
    # -- progress (owned by the scheduler) --------------------------------
    state: Optional[SbbnnlsState] = None
    done: int = 0                         # iterations completed
    losses: List[torch.Tensor] = dataclasses.field(default_factory=list)
    status: str = "queued"    # queued | running | done | failed | cancelled
    dataset: str = ""                     # content digest, set on submit
    dict_digest: str = ""                 # dictionary digest (bucket key part)
    finished_at: Optional[float] = None
    # seconds spent in earlier service incarnations (restored on resume);
    # end-to-end latency = prior_elapsed + (finished_at - submitted_at)
    prior_elapsed: float = 0.0
    # the exception that failed this job (status == "failed")
    error: Optional[BaseException] = None

    @property
    def remaining(self) -> int:
        return max(0, self.n_iters - self.done)

    def result(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(final weights (Nf,), per-iteration loss trace), both tensors on
        the scheduler's device."""
        if self.status == "failed":
            assert self.error is not None
            raise JobFailedError(self.job_id, self.error) from self.error
        if self.status == "cancelled":
            raise JobCancelledError(self.job_id)
        if self.state is None:
            raise RuntimeError(f"job {self.job_id!r} has not run yet")
        losses = (torch.cat(self.losses) if self.losses
                  else self.state.w.new_zeros((0,)))
        return self.state.w, losses


class _Bucket:
    """Jobs sharing one batch-compatibility class and their engine."""

    def __init__(self, key: Tuple, fmt: str, arrival: int,
                 tune: str = "off", compute_dtype: str = "fp32",
                 mesh: Optional[Tuple[int, int]] = None):
        self.key = key
        self.format = fmt
        self.tune = tune
        self.compute_dtype = compute_dtype
        self.mesh = mesh
        self.solo = _is_solo(fmt, mesh)
        self.jobs: List[Job] = []
        self.iters_served = 0             # virtual time for fairness
        self.arrival = arrival
        self._engine = None
        self._engine_sig: Optional[Tuple[str, ...]] = None

    # -- urgency ordering --------------------------------------------------
    def urgency(self) -> Tuple:
        deadline = min((j.deadline for j in self.jobs
                        if j.deadline is not None), default=float("inf"))
        priority = max(j.priority for j in self.jobs)
        return (deadline, -priority, self.iters_served, self.arrival)

    # -- engine construction (memoized on the member set) ------------------
    def _config(self, base: LifeConfig) -> LifeConfig:
        cfg = dataclasses.replace(base, format=self.format, tune=self.tune,
                                  compute_dtype=self.compute_dtype)
        if self.mesh is not None:
            R, C = self.mesh
            # submit checked that the format has a mesh executor
            cfg = dataclasses.replace(
                cfg, shard_rows=R, shard_cols=C,
                executor=REGISTRY.mesh_executor_for(self.format))
        return cfg

    def engine(self, base: LifeConfig, cache: PlanCache,
               device: torch.device):
        sig = tuple(j.job_id for j in self.jobs)
        if self._engine is None or self._engine_sig != sig:
            cfg = self._config(base)
            if self.solo:
                self._engine = LifeEngine(self.jobs[0].problem, cfg, cache,
                                          device=device)
            else:
                self._engine = BatchedLifeEngine(
                    [j.problem for j in self.jobs], cfg, cache,
                    device=device)
            self._engine_sig = sig
        # pin a searched dtype the moment it resolves: rebuilds (member
        # churn) and checkpoint manifests must see the numerics that ran,
        # not the open "auto" request
        if self.compute_dtype == "auto":
            self.compute_dtype = self._engine.resolved_compute_dtype
        for j in self.jobs:
            if j.compute_dtype == "auto":
                j.compute_dtype = self.compute_dtype
        return self._engine

    # -- the time slice ----------------------------------------------------
    def run_slice(self, base: LifeConfig, cache: PlanCache,
                  slice_iters: int, device: torch.device) -> List[Job]:
        """Advance every member by k <= slice_iters iterations; a member
        whose remaining budget is below k bounds the whole slice, so no job
        overruns its n_iters.  Returns the members that finished."""
        engine = self.engine(base, cache, device)
        k = min([slice_iters] + [j.remaining for j in self.jobs])
        # warm starts, per job: one micro-batch can mix warm and cold
        for j in self.jobs:
            if j.state is None and j.w0 is not None:
                j.state = sbbnnls_init(torch.as_tensor(
                    j.w0, dtype=j.problem.dictionary.dtype, device=device))
        if self.solo:
            job = self.jobs[0]
            if job.state is None:
                job.state = engine.init_state()
            if k:
                job.state, ls = engine.step(job.state, k)
                job.losses.append(ls)
                job.done += k
        else:
            if any(j.state is None for j in self.jobs):
                fresh = engine.init_states()
                for i, j in enumerate(self.jobs):
                    if j.state is None:
                        j.state = SbbnnlsState(w=fresh.w[i],
                                               it=int(fresh.it[i]),
                                               loss=fresh.loss[i])
            states = SbbnnlsState(
                w=torch.stack([j.state.w for j in self.jobs]),
                it=np.array([j.state.it for j in self.jobs], np.int32),
                loss=torch.stack([j.state.loss for j in self.jobs]))
            if k:
                states, losses = engine.step(states, k)
            for i, job in enumerate(self.jobs):
                job.state = SbbnnlsState(w=states.w[i], it=int(states.it[i]),
                                         loss=states.loss[i])
                if k:
                    job.losses.append(losses[i])
                    job.done += k
        self.iters_served += k * len(self.jobs)
        finished = [j for j in self.jobs if j.remaining == 0]
        for job in finished:
            job.status = "done"
            job.finished_at = time.monotonic()
        self.jobs = [j for j in self.jobs if j.remaining > 0]
        return finished


class Scheduler:
    """Continuous-batching micro-batch scheduler over stepped solves.

    ``device`` defaults to the CUDA card
    (:func:`repro_torch.device.resolve_device`); every bucket engine runs
    there."""

    def __init__(self, config: Optional[LifeConfig] = None, *,
                 slice_iters: int = 16, cache: Optional[PlanCache] = None,
                 device: DeviceLike = None):
        self.config = config if config is not None else LifeConfig()
        if self.config.compact_every > 0:
            # the stepped path drives engines directly and would skip
            # LifeEngine.run()'s compaction loop without a word
            raise ValueError(
                "weight compaction (compact_every > 0) is not supported by "
                "the serving scheduler; run those solves through LifeEngine")
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else PlanCache(
            self.config.plan_cache_dir, self.config.plan_cache_max_bytes)
        self.slice_iters = slice_iters
        self._queue: List[Job] = []
        self._buckets: Dict[Tuple, _Bucket] = {}
        self._jobs: Dict[str, Job] = {}
        self._arrivals = itertools.count()
        self._last_served: Optional[Tuple] = None
        # obs instruments, fetched once and held (no-ops while disabled).
        # Counter invariant across submit()/tick()/cancel():
        #   serve.jobs.admitted == serve.jobs.completed + serve.jobs.failed
        #                          + serve.jobs.cancelled
        #                          + serve.queue.depth + serve.jobs.running
        self._m_admitted = obs.counter("serve.jobs.admitted")
        self._m_completed = obs.counter("serve.jobs.completed")
        self._m_failed = obs.counter("serve.jobs.failed")
        self._m_cancelled = obs.counter("serve.jobs.cancelled")
        self._m_preempted = obs.counter("serve.preemptions")
        self._g_queue = obs.gauge("serve.queue.depth")
        self._g_running = obs.gauge("serve.jobs.running")
        self._g_buckets = obs.gauge("serve.buckets.live")
        self._h_queue = obs.histogram("serve.queue.depth")
        self._h_occupancy = obs.histogram("serve.bucket.occupancy")
        self._h_slice = obs.histogram("serve.slice.seconds")

    # -- intake ------------------------------------------------------------
    def submit(self, job: Job) -> Job:
        if job.job_id in self._jobs:
            raise ValueError(f"job id {job.job_id!r} already submitted")
        if "/" in job.job_id:
            raise ValueError("job ids must not contain '/' "
                             "(they key checkpoint array paths)")
        if job.format not in BATCHABLE_FORMATS + _SOLO_FORMATS:
            raise ValueError(
                f"format must be one of "
                f"{BATCHABLE_FORMATS + _SOLO_FORMATS}, got {job.format!r}")
        # tuning knobs: inherit the scheduler config when unset, then
        # validate with the engines' own rules (the Job carries .tune and
        # .compute_dtype, so it is the config validated)
        if job.tune is None:
            job.tune = self.config.tune
        if job.compute_dtype is None:
            job.compute_dtype = self.config.compute_dtype
        from repro_torch.tune.tuner import validate_config
        validate_config(job)
        if job.mesh is not None:
            R, C = job.mesh
            if R < 1 or C < 1:
                raise ValueError(f"mesh shape must be positive, "
                                 f"got {job.mesh}")
            have = max_cells(self.device)
            if R * C > have:
                raise ValueError(
                    f"mesh slice ({R}, {C}) needs {R * C} devices, "
                    f"have {have}")
            if REGISTRY.mesh_executor_for(job.format) is None:
                meshable = tuple(
                    f for f in BATCHABLE_FORMATS + _SOLO_FORMATS
                    if REGISTRY.mesh_executor_for(f))
                raise ValueError(
                    f"format {job.format!r} has no mesh executor; mesh "
                    f"jobs must name an explicit cell format from "
                    f"{meshable}")
        if job.w0 is not None:
            w0 = (to_numpy(job.w0) if isinstance(job.w0, torch.Tensor)
                  else np.asarray(job.w0))
            nf = job.problem.phi.n_fibers
            if w0.shape != (nf,):
                raise ValueError(f"w0 has shape {w0.shape}, expected "
                                 f"({nf},) for this problem")
            if not np.all(np.isfinite(w0)) or bool((w0 < 0).any()):
                raise ValueError("w0 must be finite and nonnegative "
                                 "(SBBNNLS iterates live in the "
                                 "nonnegative orthant)")
            job.w0 = w0
        if not job.dataset:
            job.dataset = dataset_key(job.problem)
        if not job.dict_digest:
            job.dict_digest = _dict_digest(job.problem)
        if job.submitted_at is None:      # 0.0 is a valid monotonic stamp
            job.submitted_at = time.monotonic()
        self._jobs[job.job_id] = job
        self._queue.append(job)
        self._m_admitted.inc()
        self._g_queue.set(float(len(self._queue)))
        return job

    def _bucket_key(self, job: Job) -> Tuple:
        phi = job.problem.phi
        return (phi.n_voxels, phi.n_fibers,
                int(job.problem.dictionary.shape[1]), job.dict_digest,
                job.format, job.mesh, job.tune, job.compute_dtype,
                job.job_id if _is_solo(job.format, job.mesh) else "")

    def _admit(self) -> None:
        """Move queued jobs into buckets: arrivals join their bucket's next
        micro-batch; nothing in flight restarts."""
        for job in self._queue:
            key = self._bucket_key(job)
            if key not in self._buckets:
                self._buckets[key] = _Bucket(key, job.format,
                                             next(self._arrivals),
                                             tune=job.tune,
                                             compute_dtype=job.compute_dtype,
                                             mesh=job.mesh)
            self._buckets[key].jobs.append(job)
            job.status = "running"
        self._queue.clear()

    # -- the loop ----------------------------------------------------------
    def tick(self) -> List[Job]:
        """Admit arrivals, serve the most urgent bucket one time slice.

        Returns the jobs that reached a terminal state during this tick.
        An executor exception never propagates: the bucket is quarantined
        (each member retried alone) and only the jobs that fail alone are
        marked ``failed``, with the exception captured."""
        with obs.span("scheduler.tick"):
            self._h_queue.observe(float(len(self._queue)))
            self._admit()
            self._g_queue.set(0.0)         # _admit drained the queue
            live = [b for b in self._buckets.values() if b.jobs]
            self._g_buckets.set(float(len(live)))
            self._g_running.set(float(sum(len(b.jobs) for b in live)))
            if not live:
                return []
            bucket = min(live, key=_Bucket.urgency)
            # a preemption: the most urgent bucket displaced the one served
            # last tick while that one still had members waiting to run
            last = self._last_served
            if (last is not None and last != bucket.key
                    and last in self._buckets and self._buckets[last].jobs):
                self._m_preempted.inc()
            self._last_served = bucket.key
            self._h_occupancy.observe(float(len(bucket.jobs)))
            timed = obs.SWITCH.on          # guard the clock reads too
            t0 = time.monotonic() if timed else 0.0
            try:
                with obs.span("scheduler.slice",
                              {"format": bucket.format,
                               "jobs": len(bucket.jobs)}):
                    finished = bucket.run_slice(self.config, self.cache,
                                                self.slice_iters, self.device)
            except Exception as exc:
                finished = self._quarantine(bucket, exc)
            if timed:
                self._h_slice.observe(time.monotonic() - t0)
            done = [j for j in finished if j.status == "done"]
            if done:
                self._m_completed.inc(float(len(done)))
            if finished:
                self._g_running.dec(float(len(finished)))
            cur = self._buckets.get(bucket.key)
            if cur is not None and not cur.jobs:
                del self._buckets[bucket.key]
            return finished

    # -- failure isolation --------------------------------------------------
    def _fail(self, job: Job, exc: BaseException) -> None:
        job.status = "failed"
        job.error = exc
        job.finished_at = time.monotonic()
        self._m_failed.inc()

    def _quarantine(self, bucket: _Bucket, exc: Exception) -> List[Job]:
        """A slice raised: evict the bucket and retry each member in a
        one-job probe bucket of the same class.  Members that succeed alone
        keep their advanced state and re-bucket together; members that fail
        alone are the poisoned ones.  Returns the jobs that reached a
        terminal state."""
        jobs = list(bucket.jobs)
        self._buckets.pop(bucket.key, None)
        if len(jobs) == 1:
            self._fail(jobs[0], exc)
            return jobs
        terminal: List[Job] = []
        survivors: List[Job] = []
        with obs.span("scheduler.quarantine",
                      {"format": bucket.format, "jobs": len(jobs)}):
            for job in jobs:
                probe = _Bucket(bucket.key, bucket.format, bucket.arrival,
                                tune=bucket.tune,
                                compute_dtype=bucket.compute_dtype,
                                mesh=bucket.mesh)
                probe.jobs = [job]
                try:
                    terminal.extend(probe.run_slice(
                        self.config, self.cache, self.slice_iters,
                        self.device))
                except Exception as probe_exc:
                    self._fail(job, probe_exc)
                    terminal.append(job)
                else:
                    if job.remaining > 0:
                        survivors.append(job)
        if survivors:
            fresh = _Bucket(bucket.key, bucket.format, next(self._arrivals),
                            tune=bucket.tune,
                            compute_dtype=bucket.compute_dtype,
                            mesh=bucket.mesh)
            fresh.iters_served = bucket.iters_served   # fairness carries over
            fresh.jobs = survivors
            self._buckets[bucket.key] = fresh
        return terminal

    # -- cancellation ------------------------------------------------------
    def cancel(self, job_id: str) -> bool:
        """Cancel a queued or running job; False when it is already
        terminal.  A running job leaves its bucket at once (batch-mates
        re-batch without it); its partial state stays readable on the Job
        but ``result()`` raises :class:`JobCancelledError`."""
        job = self._jobs[job_id]
        if job.status in TERMINAL_STATUSES:
            return False
        if job in self._queue:
            self._queue.remove(job)
            self._g_queue.set(float(len(self._queue)))
        else:
            bucket = next((b for b in self._buckets.values()
                           if job in b.jobs), None)
            if bucket is not None:
                bucket.jobs.remove(job)
                if not bucket.jobs:
                    del self._buckets[bucket.key]
                self._g_running.dec()
        job.status = "cancelled"
        job.finished_at = time.monotonic()
        self._m_cancelled.inc()
        return True

    def active(self) -> bool:
        return bool(self._queue) or any(b.jobs
                                        for b in self._buckets.values())

    def run_until_idle(self, max_ticks: Optional[int] = None) -> List[Job]:
        """Drive tick() until every submitted job is terminal."""
        finished: List[Job] = []
        ticks = 0
        while self.active():
            if max_ticks is not None and ticks >= max_ticks:
                break
            finished.extend(self.tick())
            ticks += 1
        return finished

    # -- introspection -----------------------------------------------------
    def job(self, job_id: str) -> Job:
        return self._jobs[job_id]

    def jobs(self) -> Sequence[Job]:
        return list(self._jobs.values())

    def in_flight(self) -> List[Job]:
        """Jobs admitted or queued but not terminal (checkpoint targets)."""
        return [j for j in self._jobs.values()
                if j.status not in TERMINAL_STATUSES]
