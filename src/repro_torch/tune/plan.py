"""TunePlan: one executor's measured launch-parameter choice.

Torch counterpart of ``repro/tune/plan.py``.  The paper's target-dependent
optimizations (its Table 9 platform sweep) are a search over launch
parameters whose winner depends on both the dataset and the hardware.  A
:class:`TunePlan` is the outcome of that search for one (dataset,
executor, backend) triple: the winning layout parameters plus the resolved
compute dtype, cached through :mod:`repro_torch.core.plan_cache` so a warm
engine rebuild replays the choice instead of measuring again.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

#: accuracy contract of ``compute_dtype="bf16"`` (bf16 storage of the
#: static operands, dictionary and Phi values, with fp32 accumulation):
#: matvec and rmatvec stay within this tolerance of the fp32 executor over
#: the whole executor x format matrix.  bf16 keeps an 8-bit mantissa, so
#: each stored operand carries ~0.4% rounding; the fp32 accumulation keeps
#: the reduction from amplifying it beyond the per-term bound.
BF16_RTOL = 2e-2
BF16_ATOL = 2e-2

#: the compute-dtype axis of the search space ("auto" resolves to one of
#: these; storage dtype only, accumulation stays fp32 either way)
COMPUTE_DTYPES = ("fp32", "bf16")

#: LifeConfig.tune modes: "off" runs the config's constants, "cached"
#: replays a persisted plan if one exists but never measures, "full"
#: searches on a miss and persists the winner.
TUNE_MODES = ("off", "cached", "full")


@dataclasses.dataclass
class TunePlan:
    """Winning launch parameters for one executor on one dataset/backend.

    ``params`` holds only the axes the executor exposes (``c_tile``/
    ``row_tile`` for the COO kernels B1/B2, ``row_tile``/``slot_tile`` for
    the SELL kernels B3/B4, ``c_tile`` for the F-COO kernels B5/B6);
    ``compute_dtype`` is always resolved ("fp32" or "bf16", never "auto").
    ``reason`` records how the plan came to be: "search" (measured),
    "default" (nothing to search: no axes and a fixed dtype), "predicted"
    (a learned predictor's answer, made with zero measurements and
    refined in place by a background search, ``repro_torch.learn``),
    or "untuned" (a tune="cached" miss: the config's constants, never
    persisted).  ``measurements`` keeps each candidate's cost (label ->
    seconds); ``stats`` the ``phi_stats`` the plan was decided under.
    """

    executor: str
    backend: str                   # device type at tune time: cpu / cuda
    n_devices: int
    params: Dict[str, int]
    compute_dtype: str
    reason: str = "search"
    measurements: Dict[str, float] = dataclasses.field(default_factory=dict)
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)

    def apply(self, config):
        """Return ``config`` with the tuned launch parameters substituted.

        Only fields the config dataclass declares are replaced, so one plan
        can parameterize configs of different shapes.
        """
        fields = {f.name for f in dataclasses.fields(config)}
        updates = {k: int(v) for k, v in self.params.items() if k in fields}
        if "compute_dtype" in fields:
            updates["compute_dtype"] = self.compute_dtype
        return dataclasses.replace(config, **updates) if updates else config

    def describe(self) -> str:
        ps = ",".join(f"{k}={v}" for k, v in sorted(self.params.items()))
        return (f"tune[{self.executor}@{self.backend}x{self.n_devices}]: "
                f"{ps or 'no tile axes'}, {self.compute_dtype} "
                f"({self.reason})")
