"""LiFE end-to-end engine: connectome pruning with pluggable SpMV executors.

Torch counterpart of ``repro/core/life.py``.  Executor dispatch goes
through :mod:`repro_torch.core.registry` (``naive``, ``opt-paper``, ``opt``,
``kernel``); the engine binds a problem to one executor on one device, runs
SBBNNLS through the stepped solver API, and reports pruning.

Tile plans are memoized through the persistent
:class:`~repro_torch.core.plan_cache.PlanCache`.  Weight compaction
(``compact_every > 0``) periodically drops coefficients whose fiber weight
reached zero and rebuilds the executor over the smaller Phi, keeping the
solver state (and so its iteration parity).

``LifeConfig`` keeps the reference's field names.  The fields of later
slices (formats, tuning, the mesh) accept only the values this slice runs,
and others raise ``ValueError`` naming the slice that brings them.  The
observability gauges arrive with the observability slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.registry import REGISTRY, Executor
from repro_torch.core.restructure import compact_by_weight
from repro_torch.core.sbbnnls import (SbbnnlsState, nnls_loss, sbbnnls_init,
                                      sbbnnls_steps)
from repro_torch.core.std import PhiTensor
from repro_torch.data.dmri import LifeProblem
from repro_torch.device import DeviceLike, resolve_device

EXECUTORS = REGISTRY.names()          # public alias; registry is the truth

#: the reference's executors that later port slices bring, by slice
#: (ROADMAP.md queue A)
LATER_EXECUTORS = {
    "kernel-sell": "the format slice (ROADMAP A5)",
    "kernel-fcoo": "the format slice (ROADMAP A5)",
    "alto": "the format slice (ROADMAP A5)",
    "auto": "the format slice (ROADMAP A5)",
    "shard": "the mesh slice (ROADMAP A13)",
    "shard-sell": "the mesh slice (ROADMAP A13)",
}


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
    shard_rows: int = 1             # mesh geometry: the mesh slice (A13)
    shard_cols: int = 1
    format: str = "coo"             # Phi layout: the format slice (A5)
    slot_tile: int = 32             # SELL slots per step (A5)
    seg_tile: int = 16              # F-COO segments per chunk (A5)
    tune: str = "off"               # kernel autotuning: the tuning slice (A7)
    predict: str = "auto"           # learned selection (A11)
    # storage dtype of the static operands (dictionary + Phi values):
    # "fp32" or "bf16" (bf16 storage, fp32 accumulation); "auto" is a
    # searched axis of the tuning slice (A7)
    compute_dtype: str = "fp32"
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
    if config.format != "coo":
        raise ValueError(f"format={config.format!r} is not ported yet: "
                         "formats arrive with the format slice (ROADMAP A5)")
    if config.tune != "off":
        raise ValueError(f"tune={config.tune!r} is not ported yet: tuning "
                         "arrives with the tuning slice (ROADMAP A7)")
    if config.compute_dtype == "auto":
        raise ValueError('compute_dtype="auto" is a searched axis of the '
                         "tuning slice (ROADMAP A7), not ported yet")
    if config.compute_dtype not in ("fp32", "bf16"):
        raise ValueError("compute_dtype must be 'fp32' or 'bf16', got "
                         f"{config.compute_dtype!r}")
    if config.shard_rows * config.shard_cols > 1:
        raise ValueError("shard_rows x shard_cols > 1 is not ported yet: the "
                         "mesh partition arrives with the mesh slice "
                         "(ROADMAP A13)")


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
        self.executor: Executor = REGISTRY.create(
            self.config.executor, phi, self.problem, self.config, self.cache)
        self.matvec = self.executor.matvec
        self.rmatvec = self.executor.rmatvec
        self.inspector_seconds += time.perf_counter() - t0

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
        return sbbnnls_steps(self.matvec, self.rmatvec, self.problem.b,
                             state, k)

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
