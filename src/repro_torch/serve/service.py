"""LifeService: submit, drive, checkpoint and resume LiFE solves.

Torch counterpart of ``repro/serve/service.py``.  Wraps
:class:`~repro_torch.serve.scheduler.Scheduler` with durability: every
``checkpoint_every`` ticks the service snapshots all solver states through
:mod:`repro_torch.checkpoint.manager` (atomic rename, retention).  A
killed service restarts, probes its checkpoint directory and re-adopts
each solve at the iteration it left off, bit for bit, because a
:class:`~repro_torch.core.sbbnnls.SbbnnlsState` is the whole solver state
(weights, iteration parity, last loss).

The checkpoint directory is the reference's: arrays keyed
``<job_id>/w``, ``/it``, ``/loss`` and ``/losses``, and per job the
manifest meta ``done``, ``n_iters``, ``priority``, ``format``,
``dataset``, ``mesh``, ``tune``, ``compute_dtype``, ``elapsed`` and
``deadline_remaining`` (plus ``error`` for a failed job).  The dataset
digest is the reference's too
(:func:`~repro_torch.serve.scheduler.dataset_key`), so either package's
service resumes the other's checkpoints.

Resume protocol: solve data is not checkpointed; the client resubmits it.
On resubmission with a known ``job_id`` the service checks the data's
digest against the one recorded at checkpoint time before it re-attaches
the restored state.

Results are torch tensors on the service's device (the reference returns a
JAX array and a numpy loss trace).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core.life import LifeConfig
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.sbbnnls import SbbnnlsState
from repro_torch.data.dmri import LifeProblem
from repro_torch.device import DeviceLike
from repro_torch.serve.scheduler import Job, Scheduler, dataset_key


class LifeService:
    """Multi-tenant solve service with checkpointed, resumable jobs.

    ``device`` defaults to the CUDA card and raises without one
    (:func:`repro_torch.device.resolve_device`)."""

    def __init__(self, config: Optional[LifeConfig] = None, *,
                 ckpt_dir: Optional[str] = None, checkpoint_every: int = 4,
                 slice_iters: int = 16, keep: int = 3,
                 cache: Optional[PlanCache] = None,
                 device: DeviceLike = None):
        self.config = config if config is not None else LifeConfig()
        self.scheduler = Scheduler(self.config, slice_iters=slice_iters,
                                   cache=cache, device=device)
        self.device = self.scheduler.device
        self.ckpt_dir = ckpt_dir
        self.checkpoint_every = checkpoint_every
        self.keep = keep
        self._tick = 0
        self._completed: Dict[str, Job] = {}
        self._failed: Dict[str, Job] = {}
        # job_id -> (restored arrays, manifest meta) awaiting resubmission
        self._resumable: Dict[str, Tuple[dict, dict]] = {}
        # obs instruments (no-ops while disabled)
        self._h_latency = obs.histogram("serve.job.latency.seconds")
        self._m_checkpoints = obs.counter("serve.checkpoints")
        self._m_ckpt_jobs = obs.counter("serve.jobs.checkpointed")
        self._m_resumed = obs.counter("serve.jobs.resumed")
        if ckpt_dir:
            self._load_resumable(ckpt_dir)

    # -- resume ------------------------------------------------------------
    def _load_resumable(self, ckpt_dir: str) -> None:
        latest = ckpt.load_latest(ckpt_dir)
        if latest is None:
            return
        step, flat, manifest = latest
        self._tick = step
        for job_id, meta in manifest.get("jobs", {}).items():
            arrays = {k.split(ckpt.SEP, 1)[1]: v for k, v in flat.items()
                      if k.split(ckpt.SEP, 1)[0] == job_id}
            if {"w", "it", "loss"} <= set(arrays):
                self._resumable[job_id] = (arrays, meta)

    @property
    def resumable_jobs(self) -> Tuple[str, ...]:
        """Job ids waiting to be re-adopted by a matching resubmission."""
        return tuple(sorted(self._resumable))

    # -- intake ------------------------------------------------------------
    def submit(self, problem: LifeProblem, *, job_id: Optional[str] = None,
               n_iters: Optional[int] = None, priority: Optional[int] = None,
               deadline: Optional[float] = None,
               format: Optional[str] = None,
               mesh: Optional[Tuple[int, int]] = None,
               tune: Optional[str] = None,
               compute_dtype: Optional[str] = None,
               w0=None) -> str:
        """Queue one solve; returns its job id.

        ``w0`` (numpy or tensor, shape ``(n_fibers,)``, finite,
        nonnegative) warm-starts a fresh job; on a resume the restored
        state is the warm start, so ``w0`` beside one is rejected.
        ``deadline`` is seconds from now.  ``mesh=(R, C)`` runs the solve
        on its format's mesh executor over an ``R x C`` local mesh.

        If ``job_id`` names a checkpointed solve, the restored state is
        re-attached once the resubmitted data's digest matches the
        checkpointed one.  Arguments passed explicitly win over the
        checkpointed values (a larger ``n_iters``, a new ``priority`` or
        ``deadline``); omitted ones are restored.  A ``format``, ``mesh``
        or ``compute_dtype`` that conflicts with the checkpointed one is an
        error: the trajectory is reproducible only under the layout and
        numerics it ran on.  ``tune`` may change freely.

        Raises:
            ValueError: a rejected resume, or anything the scheduler's
                intake rejects (an unknown format, a mesh slice it cannot
                place, a bad ``w0``).
        """
        if job_id is None:
            taken = ({j.job_id for j in self.scheduler.jobs()}
                     | set(self._completed) | set(self._resumable))
            n = len(taken)
            while f"job-{n}" in taken:
                n += 1
            job_id = f"job-{n}"
        now = time.monotonic()
        job = Job(job_id=job_id, problem=problem,
                  n_iters=self.config.n_iters if n_iters is None else n_iters,
                  priority=0 if priority is None else priority,
                  deadline=None if deadline is None else now + deadline,
                  format=self.config.format if format is None else format,
                  mesh=None if mesh is None else tuple(mesh),
                  tune=tune, compute_dtype=compute_dtype, w0=w0,
                  submitted_at=now, dataset=dataset_key(problem))
        if job_id in self._resumable:
            if w0 is not None:
                raise ValueError(
                    f"resume of job {job_id!r} rejected: a checkpointed "
                    f"state exists and is the warm start; w0 would "
                    f"silently discard it")
            arrays, meta = self._resumable[job_id]
            if meta.get("dataset") != job.dataset:
                raise ValueError(
                    f"resume of job {job_id!r} rejected: resubmitted data "
                    f"digest {job.dataset} != checkpointed "
                    f"{meta.get('dataset')}")
            ck_format = str(meta.get("format", job.format))
            if format is not None and format != ck_format:
                raise ValueError(
                    f"resume of job {job_id!r} rejected: checkpointed state "
                    f"ran under format {ck_format!r}, resubmitted with "
                    f"{format!r}")
            ck_mesh = meta.get("mesh")
            ck_mesh = None if ck_mesh is None else tuple(int(x)
                                                         for x in ck_mesh)
            if mesh is not None and tuple(mesh) != ck_mesh:
                raise ValueError(
                    f"resume of job {job_id!r} rejected: checkpointed state "
                    f"ran on mesh {ck_mesh}, resubmitted with {tuple(mesh)}")
            ck_dtype = meta.get("compute_dtype")
            if (compute_dtype is not None and ck_dtype is not None
                    and compute_dtype != ck_dtype):
                raise ValueError(
                    f"resume of job {job_id!r} rejected: checkpointed state "
                    f"ran under compute_dtype {ck_dtype!r}, resubmitted "
                    f"with {compute_dtype!r}")
            # adopt the state; the entry is consumed only once the
            # scheduler accepts the job, so a rejection there (a restored
            # mesh slice) leaves it re-adoptable
            job.format = ck_format
            job.mesh = ck_mesh
            if compute_dtype is None and ck_dtype is not None:
                job.compute_dtype = str(ck_dtype)
            if tune is None and meta.get("tune") is not None:
                job.tune = str(meta["tune"])
            job.state = SbbnnlsState(w=arrays["w"].to(self.device),
                                     it=int(arrays["it"]),
                                     loss=arrays["loss"].to(self.device))
            job.done = int(meta["done"])
            # the resume leg restarts submitted_at; the earlier legs' time
            # is restored so the latency is end to end
            job.prior_elapsed = float(meta.get("elapsed", 0.0) or 0.0)
            if n_iters is None:
                job.n_iters = int(meta.get("n_iters", job.n_iters))
            if priority is None:
                job.priority = int(meta.get("priority", 0))
            if deadline is None and meta.get("deadline_remaining") is not None:
                job.deadline = now + float(meta["deadline_remaining"])
            if "losses" in arrays:
                job.losses = [arrays["losses"].to(self.device)]
            self._m_resumed.inc()
        self.scheduler.submit(job)
        self._resumable.pop(job_id, None)
        return job_id

    # -- driving -----------------------------------------------------------
    def step(self) -> List[Job]:
        """One scheduler tick and the periodic checkpoint; returns the jobs
        that reached a terminal state (done or failed) this tick."""
        finished = self.scheduler.tick()
        self._tick += 1
        for job in finished:
            if job.status == "failed":
                self._failed[job.job_id] = job
                continue
            self._completed[job.job_id] = job
            if job.finished_at is not None:
                # end to end: legs run before a kill-and-resume are in
                # prior_elapsed
                self._h_latency.observe(job.prior_elapsed
                                        + job.finished_at - job.submitted_at)
        if (self.ckpt_dir and self.checkpoint_every > 0
                and self._tick % self.checkpoint_every == 0):
            self.checkpoint()
        return finished

    def run(self, max_ticks: Optional[int] = None
            ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Drive until every job is terminal (or ``max_ticks`` elapsed);
        returns {job_id: (weights, loss trace)} for all completed jobs."""
        ticks = 0
        while self.scheduler.active():
            if max_ticks is not None and ticks >= max_ticks:
                break
            self.step()
            ticks += 1
        if self.ckpt_dir:
            self.checkpoint()                 # never exit with unsaved state
        return {jid: job.result() for jid, job in self._completed.items()}

    # -- durability --------------------------------------------------------
    def checkpoint(self) -> Optional[str]:
        """Snapshot every solver state, in flight and completed (atomic,
        retained): a kill between a job finishing and the client reading
        its result loses nothing."""
        if not self.ckpt_dir:
            return None
        with obs.span("service.checkpoint"):
            return self._checkpoint()

    def _checkpoint(self) -> Optional[str]:
        tree: Dict[str, Dict[str, object]] = {}
        meta: Dict[str, dict] = {}
        now = time.monotonic()
        # failed jobs ride along with their last good state: resubmitting
        # one re-adopts it and retries from where it was last healthy
        for job in (self.scheduler.in_flight()
                    + list(self._completed.values())
                    + list(self._failed.values())):
            if job.state is None:
                continue                      # queued, never ran
            entry = {"w": job.state.w, "it": int(job.state.it),
                     "loss": job.state.loss}
            if job.losses:
                entry["losses"] = torch.cat(job.losses)
            tree[job.job_id] = entry
            end = job.finished_at if job.finished_at is not None else now
            meta[job.job_id] = dict(
                done=job.done, n_iters=job.n_iters, priority=job.priority,
                format=job.format, dataset=job.dataset,
                mesh=None if job.mesh is None else list(job.mesh),
                tune=job.tune, compute_dtype=job.compute_dtype,
                # cumulative wall time across service incarnations
                elapsed=job.prior_elapsed + max(0.0, end - job.submitted_at),
                # monotonic deadlines do not survive a restart; the
                # remaining budget does
                deadline_remaining=(None if job.deadline is None
                                    else job.deadline - now))
            if job.status == "failed" and job.error is not None:
                meta[job.job_id]["error"] = repr(job.error)
        # restored states nobody has resubmitted yet ride along in every
        # snapshot, so retention never rotates them out
        for job_id, (arrays, m) in self._resumable.items():
            if job_id not in tree:
                tree[job_id] = dict(arrays)
                meta[job_id] = m
        self._m_checkpoints.inc()
        self._m_ckpt_jobs.inc(float(len(tree)))
        return ckpt.save(self.ckpt_dir, self._tick, tree,
                         meta={"jobs": meta}, keep=self.keep)

    # -- introspection -----------------------------------------------------
    def job(self, job_id: str) -> Job:
        """The Job record whatever its state."""
        if job_id in self._completed:
            return self._completed[job_id]
        if job_id in self._failed:
            return self._failed[job_id]
        return self.scheduler.job(job_id)

    def result(self, job_id: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weights, loss trace); raises
        :class:`~repro_torch.serve.scheduler.JobFailedError` (chaining the
        captured exception) when the job failed."""
        return self.job(job_id).result()

    def status(self, job_id: str) -> str:
        return self.job(job_id).status

    def error(self, job_id: str) -> Optional[BaseException]:
        """The captured exception of a failed job (None otherwise)."""
        return self.job(job_id).error

    @property
    def failed_jobs(self) -> Tuple[str, ...]:
        return tuple(sorted(self._failed))

    def cancel(self, job_id: str) -> bool:
        """Cancel a queued or running job; False once it is terminal."""
        if job_id in self._completed or job_id in self._failed:
            return False
        return self.scheduler.cancel(job_id)

    @property
    def cache_stats(self):
        return self.scheduler.cache.stats

    def metrics_snapshot(self) -> dict:
        """The obs snapshot with the plan cache's stats mirrored in as
        gauges (``plan_cache.hits`` / ``.misses`` / ``.hit_rate``, counted
        since the cache was built): queue depth, latency quantiles,
        completion counters and plan-cache hit rate in one JSON-ready
        dict."""
        obs.record_cache_stats(self.scheduler.cache.stats)
        return obs.snapshot()
