"""Kernel autotuning and the runtime measurement every search shares.

Torch counterpart of ``repro/tune``.  Searches the layout parameters of
the kernel executors (the COO tiles of B1/B2, the SELL layout of B3/B4,
the F-COO chunks of B5/B6) plus the compute-dtype axis, per (dataset,
backend, device count), and persists each winner as a
:class:`~repro_torch.tune.plan.TunePlan` through the content-addressed
plan cache.  ``LifeConfig(tune="cached"|"full")`` switches it on;
``core/registry.ExecutorRegistry.create`` resolves and applies the plan
beneath every engine.  :mod:`repro_torch.tune.search` is the measurement
loop that format selection and the restructure autotune share with it.
"""
from repro_torch.tune.plan import (BF16_ATOL, BF16_RTOL, COMPUTE_DTYPES,
                                   TUNE_MODES, TunePlan)
from repro_torch.tune.space import (AXIS_CANDIDATES, TUNABLE_TILES,
                                    current_params, search_space, tile_axes)
from repro_torch.tune.tuner import (backend_name, resolve_plan,
                                    tunable_executors, validate_config)

__all__ = [
    "BF16_ATOL", "BF16_RTOL", "COMPUTE_DTYPES", "TUNE_MODES", "TunePlan",
    "AXIS_CANDIDATES", "TUNABLE_TILES", "current_params", "search_space",
    "tile_axes", "backend_name", "resolve_plan", "tunable_executors",
    "validate_config",
]
