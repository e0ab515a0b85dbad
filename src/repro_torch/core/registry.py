"""Executor registry: named factories behind one matvec/rmatvec protocol.

Torch counterpart of ``repro/core/registry.py``.  Every way of running the
two LiFE SpMV ops registers a factory under a name; the engine, tests and
``chip_smoke.py`` resolve executors through the registry.

Protocol: a factory takes ``(phi, problem, config, cache)`` and returns an
:class:`Executor` whose ``matvec(w) -> (Nv, Ntheta)`` and
``rmatvec(y) -> (Nf,)`` run DSC / WC for that code version on phi's device.
Factories that do inspector work route it through ``cache``
(:class:`~repro_torch.core.plan_cache.PlanCache`).

The ladder of this slice (paper §6.3.1/§6.4.1):

  naive        Figure-3 translation: gathers and ``index_add_`` scatters
  opt-paper    DSC voxel-sorted segment sum, WC atom-sorted scatter
  opt          output-side sorts for both ops (segment sums)
  kernel       inspector-planned COO tiles on the CUDA kernels B1/B2
               (their plain versions on the CPU)

The reference's other executors (``kernel-sell``, ``kernel-fcoo``,
``alto``, ``auto``, ``shard``, ``shard-sell``) arrive with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import spmv
from repro_torch.core.inspector import TilePlan, plan_tiles
from repro_torch.core.plan_cache import PlanCache, tile_plan_key
from repro_torch.core.restructure import sort_by_host
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
