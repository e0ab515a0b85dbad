"""Multi-tenant LiFE serving (torch counterpart of ``repro/serve``).

:class:`~repro_torch.serve.service.LifeService` turns the engines, the plan
cache and the checkpoint manager into a service: jobs arrive continuously,
compatible subjects are micro-batched through
:class:`~repro_torch.core.batched.BatchedLifeEngine`, SELL and F-COO jobs
run alone on their kernels, long solves are time-sliced fairly through the
stepped SBBNNLS API, and every solver state survives a kill through
:mod:`repro_torch.checkpoint.manager`.

The reference's async front line (``LifeFrontend``, ``JobHandle``,
``AdmissionQueueFull``, ``BACKPRESSURE_POLICIES``) imports its learned
selection and arrives with that slice (ROADMAP A11).
"""
from repro_torch.serve.scheduler import (BATCHABLE_FORMATS,
                                         TERMINAL_STATUSES, Job,
                                         JobCancelledError, JobFailedError,
                                         Scheduler, dataset_key)
from repro_torch.serve.service import LifeService

__all__ = ["BATCHABLE_FORMATS", "Job", "JobCancelledError", "JobFailedError",
           "LifeService", "Scheduler", "TERMINAL_STATUSES", "dataset_key"]
