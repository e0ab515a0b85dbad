"""LiFE end-to-end engine: connectome pruning with pluggable SpMV executors.

Torch counterpart of ``repro/core/life.py``.  Executor dispatch goes
through :mod:`repro_torch.core.registry` (``naive``, ``opt-paper``, ``opt``,
``kernel``, ``kernel-sell``, ``kernel-fcoo``, ``alto``, ``auto``, and the
mesh executors ``shard`` / ``shard-sell``); the engine binds a problem to
one executor rooted at one device, runs SBBNNLS through the stepped solver
API, and reports pruning.  ``format`` other than ``"coo"`` ("sell",
"fcoo", "alto", or "auto", which selects one per dataset) goes through
``registry.create_for_format``.  A multi-cell mesh request
(``shard_rows * shard_cols > 1``) with ``format="coo"`` routes to the
format's mesh executor (``shard``), as in the reference.

Tile, SpMV and format plans are memoized through the persistent
:class:`~repro_torch.core.plan_cache.PlanCache`.  Weight compaction
(``compact_every > 0``) periodically drops coefficients whose fiber weight
reached zero and rebuilds the executor over the smaller Phi, keeping the
solver state (and so its iteration parity).

``LifeConfig`` keeps the reference's field names.  ``tune="cached"`` or
``"full"`` resolves a :class:`~repro_torch.tune.plan.TunePlan` beneath the
executor (``tune/tuner.py``; ``compute_dtype="auto"`` is its searched
dtype axis).

Observability (:mod:`repro_torch.obs`), the reference's instruments: the
``engine.build.seconds`` histogram per build, and per stepped call the
``engine.step`` span, the ``engine.step.seconds`` histogram and the
``engine.roofline.fraction`` / ``engine.achieved_bandwidth.gbps`` gauges.
The bytes behind the gauges are the SpMVs' compulsory bytes
(:mod:`repro_torch.roofline.spmv_bytes`), not a count from compiled code.
While observability is on, a step fences the card before and after its
launches, so the timed window ends when the device work does; while it is
off, a step neither synchronizes nor allocates for the instruments.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.registry import REGISTRY, Executor, create_for_format
from repro_torch.core.restructure import compact_by_weight
from repro_torch.core.sbbnnls import (SbbnnlsState, nnls_loss, sbbnnls_init,
                                      sbbnnls_steps)
from repro_torch.core.std import PhiTensor
from repro_torch.data.dmri import LifeProblem
from repro_torch.device import DeviceLike, fence, resolve_device
from repro_torch.tune.tuner import validate_config as validate_tuning

EXECUTORS = REGISTRY.names()          # public alias; registry is the truth

#: the reference's executors that later port slices bring, by slice
#: (ROADMAP.md queue A); none is left
LATER_EXECUTORS: dict = {}

#: Phi layouts ``LifeConfig.format`` accepts ("auto" selects one per dataset)
FORMAT_CHOICES = ("coo", "sell", "alto", "fcoo", "auto")


@dataclasses.dataclass
class LifeConfig:
    """Engine configuration, with the reference's field names.

    Code version (``executor``, ``format``, mesh geometry), kernel launch
    parameters (``c_tile``, ``row_tile``, ``slot_tile``, ``seg_tile``),
    plan-selection policy (``tune``, ``predict``, the SELL thresholds,
    ``compute_dtype``) and the solver driver (``n_iters``, compaction).
    """

    executor: str = "opt"
    n_iters: int = 100
    compact_every: int = 0          # 0 disables weight compaction
    compact_threshold: float = 0.0
    c_tile: int = 256               # kernel coefficient-tile size
    row_tile: int = 8               # kernel output row-block size
    # the reference's Pallas interpret switch; the port has no interpret
    # mode (a CUDA tensor runs the kernel, a CPU tensor its plain version)
    kernel_interpret: bool = True
    # mesh geometry (R, C) of the shard executors; with R*C > 1 the
    # format="auto" candidates and the executor mapping become mesh-aware
    shard_rows: int = 1
    shard_cols: int = 1
    # Phi layout: "coo" (canonical; executor= picks the code version),
    # "sell" / "fcoo" / "alto" (that format's executor), or "auto" (picked
    # per dataset by formats/select.py, FormatPlan-cached)
    format: str = "coo"
    slot_tile: int = 32             # SELL width is a multiple of this
    seg_tile: int = 16              # F-COO segments per chunk round to this
    # kernel autotuning (tune/tuner.py): "off" runs the constants above;
    # "cached" replays a persisted TunePlan when one exists (never
    # measures); "full" searches the layout space on a cache miss and
    # persists the winner per (dataset, executor, backend, devices)
    tune: str = "off"
    # learned selection (repro_torch.learn): "auto" lets a trained
    # predictor.json beside the plan cache answer format and tune-plan
    # misses with zero measurements (reason "predicted", refined in the
    # background); "off" skips that rung
    predict: str = "auto"
    # storage dtype of the static operands (dictionary + Phi values):
    # "fp32", "bf16" (bf16 storage, fp32 accumulation; accuracy contract
    # tune/plan.py BF16_RTOL) or "auto" (a searched axis; needs tune !=
    # "off")
    compute_dtype: str = "fp32"
    # cap on measured candidates per search (the default configuration is
    # never truncated away)
    tune_budget: int = 12
    sell_accept: float = 1.0
    sell_reject: float = 4.0
    # None -> default cache dir ($REPRO_PLAN_CACHE or ~/.cache/repro-life);
    # "" -> plan caching disabled.
    plan_cache_dir: Optional[str] = None
    # cap on the on-disk plan cache (oldest entries pruned past it);
    # None -> $REPRO_PLAN_CACHE_MAX_BYTES or unbounded.
    plan_cache_max_bytes: Optional[int] = None


def validate_config(config: LifeConfig) -> None:
    """Raise ValueError for values this slice of the port does not run."""
    name = config.executor
    if name in LATER_EXECUTORS:
        raise ValueError(f"executor {name!r} is not ported yet: it arrives "
                         f"with {LATER_EXECUTORS[name]}")
    if name not in REGISTRY:
        raise ValueError(f"executor must be one of {REGISTRY.names()}, "
                         f"got {name!r}")
    if config.format not in FORMAT_CHOICES:
        raise ValueError(f"format must be one of {FORMAT_CHOICES}, got "
                         f"{config.format!r}")
    validate_tuning(config)


class LifeEngine:
    """Binds a LifeProblem to an executor on one device; runs SBBNNLS;
    reports pruning.

    ``device`` defaults to the CUDA card and raises without one
    (:func:`repro_torch.device.resolve_device`); the problem is moved there.
    """

    def __init__(self, problem: LifeProblem, config: LifeConfig,
                 cache: Optional[PlanCache] = None, *,
                 device: DeviceLike = None):
        validate_config(config)
        self.device = resolve_device(device)
        self.problem = problem.to(self.device)
        self.config = config
        self.cache = cache if cache is not None else PlanCache(
            config.plan_cache_dir, config.plan_cache_max_bytes)
        self.inspector_seconds = 0.0
        self._build(self.problem.phi)

    # -- inspector ----------------------------------------------------------
    def _build(self, phi: PhiTensor) -> None:
        t0 = time.perf_counter()
        self.phi = phi
        if self.config.format == "coo":
            name = self.config.executor
            if self.config.shard_rows * self.config.shard_cols > 1:
                # a multi-cell mesh request wins: route through the
                # mesh-aware mapping (-> "shard") rather than run the
                # configured executor on one device
                from repro_torch.formats import select as fsel
                name = fsel.executor_for("coo", self.config)
            self.executor: Executor = REGISTRY.create(
                name, phi, self.problem, self.config, self.cache)
        else:
            # "sell" / "fcoo" / "alto" run that layout's executor; "auto"
            # selects per dataset (FormatPlan-cached)
            self.executor = create_for_format(phi, self.problem, self.config,
                                              self.cache)
        self.matvec = self.executor.matvec
        self.rmatvec = self.executor.rmatvec
        dt = time.perf_counter() - t0
        self.inspector_seconds += dt
        obs.histogram("engine.build.seconds").observe(dt)
        # held instruments for the step loop (no-ops while disabled); the
        # byte count is dropped here because compaction rebinds the SpMVs
        # over a smaller Phi
        self._op_bytes: Optional[float] = None
        self._h_step = obs.histogram("engine.step.seconds",
                                     executor=self.executor.name)
        self._g_frac = obs.gauge("engine.roofline.fraction",
                                 executor=self.executor.name,
                                 format=self.config.format)
        self._g_bw = obs.gauge("engine.achieved_bandwidth.gbps",
                               executor=self.executor.name,
                               format=self.config.format)

    @property
    def format_plan(self):
        """Chosen FormatPlan (format != "coo" only; None otherwise)."""
        return self.executor.plans.get("format")

    @property
    def tune_plan(self):
        """Resolved TunePlan (tune != "off" only; None otherwise)."""
        return self.executor.plans.get("tune")

    @property
    def resolved_compute_dtype(self) -> str:
        """The storage dtype this engine runs under: the tune plan's
        winner when a search resolved ``compute_dtype="auto"``, the config
        value otherwise."""
        plan = self.tune_plan
        if plan is not None:
            return plan.compute_dtype
        cd = self.config.compute_dtype
        return "fp32" if cd == "auto" else cd

    @property
    def dsc_plan(self):
        """Autotuned DSC SpmvPlan (auto executor only; None otherwise)."""
        return self.executor.plans.get("dsc")

    @property
    def wc_plan(self):
        """Autotuned WC SpmvPlan (auto executor only; None otherwise)."""
        return self.executor.plans.get("wc")

    @property
    def cache_stats(self):
        """Hit/miss counters of the bound plan cache (CacheStats)."""
        return self.cache.stats

    # -- driver --------------------------------------------------------------
    def init_state(self, w0: Optional[torch.Tensor] = None) -> SbbnnlsState:
        """Fresh solver state (all-ones start unless ``w0`` is given)."""
        if w0 is None:
            w0 = torch.ones((self.problem.phi.n_fibers,),
                            dtype=self.problem.dictionary.dtype,
                            device=self.device)
        return sbbnnls_init(w0.to(self.device))

    def step(self, state: SbbnnlsState, k: int
             ) -> Tuple[SbbnnlsState, torch.Tensor]:
        """Advance ``state`` by ``k`` SBBNNLS iterations (stepped API).

        The iteration counter rides in the state, so chained calls
        reproduce one uninterrupted run exactly.  The losses stay on the
        device."""
        if not obs.SWITCH.on:
            return sbbnnls_steps(self.matvec, self.rmatvec, self.problem.b,
                                 state, k)
        with obs.span("engine.step", {"executor": self.executor.name,
                                      "format": self.config.format,
                                      "k": k}) as sp:
            fence(self.device)
            t0 = time.perf_counter()
            new, ls = sbbnnls_steps(self.matvec, self.rmatvec,
                                    self.problem.b, state, k)
            fence(self.device)
            dt = time.perf_counter() - t0
            self._h_step.observe(dt)
            self._annotate_roofline(sp, k, dt)
        return new, ls

    def _annotate_roofline(self, sp, k: int, dt: float) -> None:
        """Set the achieved-bandwidth gauges and span attributes (obs on
        only): the weighted compulsory bytes of an iteration times ``k``
        over the step's seconds, against the card's HBM rate."""
        if dt <= 0.0:
            return
        from repro_torch.roofline.analysis import HW
        bytes_per_iter = self._op_bytes_per_iter()
        achieved = bytes_per_iter * k / dt
        frac = achieved / HW["hbm_bw"]
        self._g_bw.set(achieved / 1e9)
        self._g_frac.set(frac)
        sp.set_attr("bytes_accessed", bytes_per_iter * k)
        sp.set_attr("achieved_gbps", achieved / 1e9)
        sp.set_attr("roofline_fraction", frac)

    def _op_bytes_per_iter(self) -> float:
        """Weighted compulsory bytes of one SBBNNLS iteration over the
        bound executor (memoized until the next build)."""
        if self._op_bytes is None:
            from repro_torch.roofline import spmv_bytes
            n_atoms, n_theta = self.problem.dictionary.shape
            dsc, wc = spmv_bytes.executor_work(
                self.executor, self.phi, n_theta, n_atoms,
                self.resolved_compute_dtype)
            self._op_bytes = spmv_bytes.iteration_bytes(dsc, wc)
        return self._op_bytes

    def run(self, n_iters: Optional[int] = None,
            w0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run SBBNNLS with optional periodic weight compaction; returns
        (weights, losses), both on the device."""
        cfg = self.config
        n_iters = cfg.n_iters if n_iters is None else n_iters
        state = self.init_state(w0)
        losses: List[torch.Tensor] = []
        chunk = cfg.compact_every if cfg.compact_every > 0 else n_iters
        done = 0
        while done < n_iters:
            k = min(chunk, n_iters - done)
            state, ls = self.step(state, k)
            losses.append(ls)
            done += k
            if cfg.compact_every > 0 and done < n_iters:
                t0 = time.perf_counter()
                compacted = compact_by_weight(self.phi, state.w,
                                              cfg.compact_threshold)
                # _build adds its own time; counting it here too would
                # count the rebuild twice (the reference does)
                self.inspector_seconds += time.perf_counter() - t0
                if compacted.n_coeffs < self.phi.n_coeffs:
                    self._build(compacted)
        if not losses:
            return state.w, state.w.new_zeros((0,))
        return state.w, torch.cat(losses)

    def loss(self, w: torch.Tensor) -> float:
        """NNLS objective ``0.5 * ||M w - b||^2`` under this engine's bound
        SpMV (so a compacted engine scores against its own Phi)."""
        return float(nnls_loss(self.matvec, self.problem.b, w.to(self.device)))

    def prune_stats(self, w: torch.Tensor, threshold: float = 1e-6) -> dict:
        """Support recovery vs the synthetic ground truth.

        Returns:
            dict with ``kept``/``total`` counts and ``precision``/
            ``recall`` of the recovered support against ``w_true > 0``.
        """
        w_np = w.detach().float().cpu().numpy()
        true = self.problem.w_true.detach().float().cpu().numpy() > 0
        kept = w_np > threshold
        tp = float(np.sum(kept & true))
        return dict(
            kept=float(kept.sum()),
            total=float(kept.size),
            precision=tp / max(1.0, float(kept.sum())),
            recall=tp / max(1.0, float(true.sum())),
        )
