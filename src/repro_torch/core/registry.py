"""Executor registry: named factories behind one matvec/rmatvec protocol.

Torch counterpart of ``repro/core/registry.py``.  Every way of running the
two LiFE SpMV ops registers a factory under a name; the engine, tests and
``chip_smoke.py`` resolve executors through the registry.

Protocol: a factory takes ``(phi, problem, config, cache)`` and returns an
:class:`Executor` whose ``matvec(w) -> (Nv, Ntheta)`` and
``rmatvec(y) -> (Nf,)`` run DSC / WC for that code version on phi's device.
Factories that do inspector work route it through ``cache``
(:class:`~repro_torch.core.plan_cache.PlanCache`).

The ladder (paper §6.3.1/§6.4.1):

  naive        Figure-3 translation: gathers and ``index_add_`` scatters
  opt-paper    DSC voxel-sorted segment sum, WC atom-sorted scatter
  opt          output-side sorts for both ops (segment sums)
  kernel       inspector-planned COO tiles on the CUDA kernels B1/B2
  kernel-sell  blocked-ELL layout (formats/sell.py) on kernels B3/B4
  kernel-fcoo  ONE segment-flagged F-COO stream (formats/fcoo.py) feeding
               both ops through kernels B5 and B6, which write y and w
               directly (carries of runs across chunks, an ordered fold,
               no atomics)
  alto         ALTO single-index sort order (formats/alto.py), one Phi copy
               serving both ops through the naive ops
  auto         runtime autotune of the sort dimension per op (paper §4.1.2)

The kernel executors run their plain versions on CPU tensors.

``create_for_format`` resolves ``LifeConfig.format`` ("coo", "sell",
"alto", "fcoo", or "auto" through ``formats/select.py``) to the executor
that consumes that layout and records the FormatPlan in its ``plans``.
The mesh executors (``shard``, ``shard-sell``) arrive with the mesh slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import spmv
from repro_torch.core.inspector import TilePlan, plan_tiles
from repro_torch.core.plan_cache import (PlanCache, spmv_plan_key,
                                         tile_plan_key)
from repro_torch.core.restructure import (SpmvPlan, autotune_plan,
                                          sort_by_host)
from repro_torch.core.std import PhiTensor

MatVec = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class Executor:
    """A bound pair of SpMV closures plus inspector diagnostics."""

    name: str
    matvec: MatVec                        # w (Nf,) -> y (Nv, Ntheta)
    rmatvec: MatVec                       # y (Nv, Ntheta) -> w (Nf,)
    plans: Dict[str, object] = dataclasses.field(default_factory=dict)


ExecutorFactory = Callable[..., Executor]


class ExecutorRegistry:
    """Name -> factory mapping with decorator registration.

    ``consumes`` records which Phi layout a factory runs over and ``mesh``
    whether it is a mesh-partitioned path, as in the reference, so later
    slices (formats, serving, the mesh) derive their pairings from it.
    """

    def __init__(self):
        self._factories: Dict[str, ExecutorFactory] = {}
        self._consumes: Dict[str, str] = {}
        self._mesh: Dict[str, bool] = {}

    def register(self, name: str, *, consumes: str = "coo",
                 mesh: bool = False
                 ) -> Callable[[ExecutorFactory], ExecutorFactory]:
        """Decorator registering an executor factory.

        Raises:
            ValueError: when ``name`` is already registered.
        """
        def deco(factory: ExecutorFactory) -> ExecutorFactory:
            if name in self._factories:
                raise ValueError(f"executor {name!r} already registered")
            self._factories[name] = factory
            self._consumes[name] = consumes
            self._mesh[name] = mesh
            return factory
        return deco

    def names(self) -> Tuple[str, ...]:
        """All registered executor names, sorted."""
        return tuple(sorted(self._factories))

    def consumes(self, name: str) -> str:
        """Phi layout executor ``name`` runs over."""
        if name not in self._consumes:
            raise ValueError(
                f"executor must be one of {self.names()}, got {name!r}")
        return self._consumes[name]

    def executors_for_format(self, format_name: str) -> Tuple[str, ...]:
        """All registered executors that run over ``format_name``."""
        return tuple(sorted(n for n, f in self._consumes.items()
                            if f == format_name))

    def __contains__(self, name: str) -> bool:
        return name in self._factories

    def create(self, name: str, phi: PhiTensor, problem, config,
               cache: Optional[PlanCache] = None) -> Executor:
        """Instantiate executor ``name`` for ``phi`` (which may be a
        compacted descendant of ``problem.phi``) on phi's device."""
        if name not in self._factories:
            raise ValueError(
                f"executor must be one of {self.names()}, got {name!r}")
        if cache is None:
            cache = PlanCache("")        # disabled cache
        return self._factories[name](phi, problem, config, cache)


REGISTRY = ExecutorRegistry()


# ----------------------------------------------------------------------------
# Built-in factories
# ----------------------------------------------------------------------------

def _with_storage_dtype(phi: PhiTensor, dictionary: torch.Tensor, config):
    """bf16 storage of the static operands for the plain executors; ``w``
    and ``Y`` stay float32, so every product promotes to float32 before a
    reduction (bf16 storage, fp32 accumulate)."""
    if config.compute_dtype != "bf16":
        return phi, dictionary
    return phi.astype(torch.bfloat16), dictionary.to(torch.bfloat16)


@REGISTRY.register("naive")
def _make_naive(phi, problem, config, cache) -> Executor:
    phi, d = _with_storage_dtype(phi, problem.dictionary, config)
    return Executor(
        name="naive",
        matvec=lambda w: spmv.dsc_naive(phi, d, w),
        rmatvec=lambda y: spmv.wc_naive(phi, d, y))


@REGISTRY.register("opt")
def _make_opt(phi, problem, config, cache) -> Executor:
    phi, d = _with_storage_dtype(phi, problem.dictionary, config)
    phi_v, _ = sort_by_host(phi, "voxel")
    phi_w, _ = sort_by_host(phi, "fiber")
    len_v = spmv.segment_lengths(phi_v.voxels, phi.n_voxels)
    len_w = spmv.segment_lengths(phi_w.fibers, phi.n_fibers)
    return Executor(
        name="opt",
        matvec=lambda w: spmv.dsc(phi_v, d, w, len_v),
        rmatvec=lambda y: spmv.wc(phi_w, d, y, len_w))


@REGISTRY.register("opt-paper")
def _make_opt_paper(phi, problem, config, cache) -> Executor:
    phi, d = _with_storage_dtype(phi, problem.dictionary, config)
    phi_v, _ = sort_by_host(phi, "voxel")
    phi_w, _ = sort_by_host(phi, "atom")
    len_v = spmv.segment_lengths(phi_v.voxels, phi.n_voxels)
    return Executor(
        name="opt-paper",
        matvec=lambda w: spmv.dsc(phi_v, d, w, len_v),
        rmatvec=lambda y: spmv.wc_atom_sorted(phi_w, d, y))


def planned_tiles(sorted_ids: np.ndarray, n_rows: int, *, c_tile: int,
                  row_tile: int, cache: PlanCache, backend: str) -> TilePlan:
    """plan_tiles through the persistent cache (content-addressed, keyed by
    backend too)."""
    key = tile_plan_key(sorted_ids, n_rows, c_tile=c_tile, row_tile=row_tile,
                        backend=backend)
    plan = cache.get_tile_plan(key)
    if plan is None:
        plan = plan_tiles(sorted_ids, n_rows, c_tile=c_tile, row_tile=row_tile)
        cache.put_tile_plan(key, plan)
    return plan


@REGISTRY.register("kernel")
def _make_kernel(phi, problem, config, cache) -> Executor:
    from repro_torch.kernels import ops as kops
    d = problem.dictionary
    backend = phi.device.type
    phi_v, _ = sort_by_host(phi, "voxel")
    phi_w, _ = sort_by_host(phi, "fiber")
    dsc_plan = planned_tiles(phi_v.voxels.cpu().numpy(), phi.n_voxels,
                             c_tile=config.c_tile, row_tile=config.row_tile,
                             cache=cache, backend=backend)
    wc_plan = planned_tiles(phi_w.fibers.cpu().numpy(), phi.n_fibers,
                            c_tile=config.c_tile, row_tile=config.row_tile,
                            cache=cache, backend=backend)
    cd = config.compute_dtype
    return Executor(
        name="kernel",
        matvec=kops.make_dsc(phi_v, d, dsc_plan, compute_dtype=cd),
        rmatvec=kops.make_wc(phi_w, d, wc_plan, compute_dtype=cd),
        plans=dict(dsc_tiles=dsc_plan, wc_tiles=wc_plan))


@REGISTRY.register("kernel-sell", consumes="sell")
def _make_kernel_sell(phi, problem, config, cache) -> Executor:
    """Kernels B3/B4 over the blocked-ELL layout (formats/sell.py).  The
    SELL encode replaces the tile planner: the layout's slot arrays are the
    plan."""
    from repro_torch.formats.sell import SellPhi
    from repro_torch.kernels import ops as kops
    d = problem.dictionary
    sell_dsc = SellPhi.encode(phi, op="dsc", row_tile=config.row_tile,
                              slot_tile=config.slot_tile)
    sell_wc = SellPhi.encode(phi, op="wc", row_tile=config.row_tile,
                             slot_tile=config.slot_tile)
    cd = config.compute_dtype
    return Executor(
        name="kernel-sell",
        matvec=kops.make_dsc_sell(sell_dsc, d, compute_dtype=cd),
        rmatvec=kops.make_wc_sell(sell_wc, d, compute_dtype=cd),
        plans=dict(sell_dsc=sell_dsc, sell_wc=sell_wc))


@REGISTRY.register("kernel-fcoo", consumes="fcoo")
def _make_kernel_fcoo(phi, problem, config, cache) -> Executor:
    """Kernels B5/B6 over ONE F-COO copy (formats/fcoo.py): the single
    linearized stream serves matvec AND rmatvec; the WC view is read
    through ``wc_perm`` inside B6, not copied (only its fibers are, so B6
    finds its runs with coalesced loads).  Each op is one launch that
    writes its output, with no partials to combine."""
    from repro_torch.formats.fcoo import FcooPhi
    from repro_torch.kernels import ops as kops
    fc = FcooPhi.encode(phi, c_tile=config.c_tile, seg_tile=config.seg_tile)
    o = kops.fcoo_operands(fc, problem.dictionary.device,
                           compute_dtype=config.compute_dtype)
    matvec, rmatvec = kops.make_fcoo_ops(fc, problem.dictionary,
                                         compute_dtype=config.compute_dtype,
                                         operands=o)
    return Executor(name="kernel-fcoo", matvec=matvec, rmatvec=rmatvec,
                    plans=dict(fcoo=fc, fcoo_operands=o))


@REGISTRY.register("alto", consumes="alto")
def _make_alto(phi, problem, config, cache) -> Executor:
    """Both ops over one ALTO-ordered Phi copy (formats/alto.py): the
    linearized sort gives locality in every mode at once, so one
    coefficient order feeds DSC and WC."""
    from repro_torch.formats.alto import AltoPhi
    enc, _ = AltoPhi.encode(phi).sort()
    phi_lin, d = _with_storage_dtype(enc.decode(), problem.dictionary,
                                     config)
    # keep accounting only: retaining `enc` would hold a second
    # (lin, values) copy alive for the executor's lifetime
    meta = dict(n_coeffs=enc.n_coeffs, nbytes=enc.nbytes)
    return Executor(
        name="alto",
        matvec=lambda w: spmv.dsc_naive(phi_lin, d, w),
        rmatvec=lambda y: spmv.wc_naive(phi_lin, d, y),
        plans=dict(alto=meta))


def create_for_format(phi, problem, config,
                      cache: Optional[PlanCache] = None) -> Executor:
    """Resolve ``config.format`` (possibly "auto") to a bound executor.

    The chosen or cached FormatPlan lands in ``executor.plans["format"]``.
    ``format="coo"`` runs the executor named by ``config.executor`` over
    the canonical layout.
    """
    from repro_torch.formats import select as fsel
    if cache is None:
        cache = PlanCache("")
    plan = fsel.resolve_format(phi, problem, config, cache)
    executor = REGISTRY.create(fsel.executor_for(plan.format, config), phi,
                               problem, config, cache)
    executor.plans["format"] = plan
    return executor


# per sort-dim executors: output-side sorts get segment-sum paths,
# input-side sorts keep the scatter (paper Table 2/3 combinations)
_DSC_FNS = {"atom": spmv.dsc_atom_sorted, "voxel": spmv.dsc,
            "fiber": spmv.dsc_atom_sorted}   # fiber-sort: unsorted Y path
_WC_FNS = {"atom": spmv.wc_atom_sorted, "voxel": spmv.wc_atom_sorted,
           "fiber": spmv.wc}


@REGISTRY.register("auto")
def _make_auto(phi, problem, config, cache) -> Executor:
    """The paper's runtime selection: per op, time each sort dimension's
    executor and keep the fastest (SpmvPlans through the plan cache)."""
    phi, d = _with_storage_dtype(phi, problem.dictionary, config)
    probe_dtype = problem.dictionary.dtype     # probes mimic solver operands
    atoms, voxels, fibers = (x.cpu().numpy()
                             for x in (phi.atoms, phi.voxels, phi.fibers))
    backend = phi.device.type

    def tuned(op: str, run) -> SpmvPlan:
        key = spmv_plan_key(op, atoms, voxels, fibers, backend=backend)
        plan = cache.get_spmv_plan(key)
        if plan is None:
            plan = autotune_plan(op, phi, run)
            cache.put_spmv_plan(key, plan)
        if plan.order is None:      # cached choice without the permutation
            _, plan.order = sort_by_host(phi, plan.restructure)
        return plan

    w_probe = torch.ones((phi.n_fibers,), dtype=probe_dtype,
                         device=phi.device)
    y_probe = torch.ones((phi.n_voxels, d.shape[1]), dtype=probe_dtype,
                         device=phi.device)
    dsc_plan = tuned("dsc", lambda p, dim: _DSC_FNS[dim](p, d, w_probe))
    wc_plan = tuned("wc", lambda p, dim: _WC_FNS[dim](p, d, y_probe))

    phi_v = phi.take(dsc_plan.order)
    phi_w = phi.take(wc_plan.order)
    dsc_fn = _DSC_FNS[dsc_plan.restructure]
    wc_fn = _WC_FNS[wc_plan.restructure]
    return Executor(
        name="auto",
        matvec=lambda w: dsc_fn(phi_v, d, w),
        rmatvec=lambda y: wc_fn(phi_w, d, y),
        plans=dict(dsc=dsc_plan, wc=wc_plan))
