"""Multi-tenant LiFE serving (torch counterpart of ``repro/serve``).

:class:`~repro_torch.serve.service.LifeService` turns the engines, the plan
cache and the checkpoint manager into a service: jobs arrive continuously,
compatible subjects are micro-batched through
:class:`~repro_torch.core.batched.BatchedLifeEngine`, SELL and F-COO jobs
run alone on their kernels, long solves are time-sliced fairly through the
stepped SBBNNLS API, and every solver state survives a kill through
:mod:`repro_torch.checkpoint.manager`.

:class:`~repro_torch.serve.frontend.LifeFrontend` is the traffic-facing
front line: async submission (``submit_async`` -> :class:`JobHandle`), a
bounded admission queue with configurable backpressure, per-job failure
isolation (one bad tenant fails alone, batch-mates keep running), and
graceful drain-and-checkpoint shutdown.
"""
from repro_torch.serve.frontend import (BACKPRESSURE_POLICIES,
                                        AdmissionQueueFull, JobHandle,
                                        LifeFrontend, ShutdownError)
from repro_torch.serve.scheduler import (BATCHABLE_FORMATS,
                                         TERMINAL_STATUSES, Job,
                                         JobCancelledError, JobFailedError,
                                         Scheduler, dataset_key)
from repro_torch.serve.service import LifeService

__all__ = ["AdmissionQueueFull", "BACKPRESSURE_POLICIES",
           "BATCHABLE_FORMATS", "Job", "JobCancelledError", "JobFailedError",
           "JobHandle", "LifeFrontend", "LifeService", "Scheduler",
           "ShutdownError", "TERMINAL_STATUSES", "dataset_key"]
