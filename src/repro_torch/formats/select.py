"""Per-dataset format selection: heuristic first, measurement when unsure.

Torch counterpart of ``repro/formats/select.py`` (Chen et al.,
arXiv:1805.11938: no single SpMV format wins across matrices).  The
decision ladder:

1. **Cache** — the choice is a :class:`~repro_torch.formats.base.FormatPlan`
   keyed by ``plan_cache.format_plan_key`` (full index content, geometry,
   candidate set, thresholds, backend and the executor the coo candidate
   runs on); a warm engine rebuild loads it and never selects again.  A
   hit on a ``reason="predicted"`` plan re-enqueues its refinement (a
   process restart dropped the queue).
2. **Predict** — a trained :class:`~repro_torch.learn.model.Predictor`
   beside the cache directory (``predictor.json``, unless
   ``LifeConfig.predict="off"``) answers the miss from ``phi_stats``
   features alone (``reason="predicted"``, zero measurements, the
   ``select.predicted`` span and ``learn.predict`` counters); the heuristic
   and measured rungs are queued on :data:`repro_torch.learn.refine.QUEUE`,
   and the task overwrites the cached plan in place.
3. **Heuristic** — from :func:`repro_torch.core.inspector.phi_stats`:
   SELL's padding overhead is known from run lengths without encoding.
   Overhead at most ``sell_accept`` extra slots per coefficient takes SELL
   outright; at least ``sell_reject`` strikes SELL from the candidates.
4. **Measure** — whenever more than one candidate survives, time each
   candidate's DSC (the dominant op, 2 calls per iteration against WC's
   1.5) through ``restructure.autotune_plan``, the same three-run loop as
   the paper's runtime restructuring choice.

The measured rung times what each candidate's executor runs: kernel B3 for
sell, kernel B5 (which folds its chunks itself) for fcoo, and the
registry's executor for alto and for coo.  The coo candidate runs on the
executor ``executor_for("coo", config)`` names, so under
``executor="kernel"`` it is timed on kernel B1 over the inspector's tile
plan, and under ``"opt"`` on the voxel-sorted segment-sum DSC.  (The
reference times its SELL and F-COO jnp references instead, because off
the TPU its kernels run interpreted.)  On CPU tensors each of them is its
plain version.

``resolve_format`` is the engine entry point: it honours an explicit
``LifeConfig.format`` (``reason="explicit"``) and maps the chosen format to
the executor registry name.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.bridge import to_numpy
from repro_torch.core.inspector import phi_stats
from repro_torch.core.restructure import autotune_plan
from repro_torch.core.std import PhiTensor
from repro_torch.formats.base import FormatPlan, format_names
from repro_torch.formats.fcoo import FcooPhi
from repro_torch.formats.sell import (DEFAULT_ROW_TILE, DEFAULT_SLOT_TILE,
                                      SellPhi)

#: SELL padding-overhead thresholds (extra slots per real coefficient)
DEFAULT_SELL_ACCEPT = 1.0
DEFAULT_SELL_REJECT = 4.0

#: format name -> executor registry name; None = defer to config.executor
#: (COO is what every COO executor already consumes)
_FORMAT_EXECUTORS = {"coo": None, "sell": "kernel-sell", "alto": "alto",
                     "fcoo": "kernel-fcoo"}

#: the kernel executor's coefficient tile (LifeConfig.c_tile's default)
DEFAULT_C_TILE = 256

#: default "auto" candidate set (every leaf format)
DEFAULT_CANDIDATES = ("coo", "sell", "alto", "fcoo")


def _mesh_cells(config) -> int:
    return (getattr(config, "shard_rows", 1)
            * getattr(config, "shard_cols", 1))


def executor_for(format_name: str, config) -> str:
    """Registry name that runs a format.

    In order: (1) under a multi-cell mesh request (``shard_rows *
    shard_cols > 1``) the format's mesh executor, from the registry's
    ``mesh=`` metadata, even over an explicit single-device executor;
    (2) an explicitly configured executor that itself consumes the format
    (so ``executor="shard-sell", format="sell"`` runs the sharded path on
    a 1x1 mesh); (3) the format's own executor (COO defers to
    ``config.executor``)."""
    if format_name not in _FORMAT_EXECUTORS:
        raise ValueError(
            f"format must be one of {format_names()}, got {format_name!r}")
    from repro_torch.core.registry import REGISTRY
    requested = config.executor
    if _mesh_cells(config) > 1:
        sharded = REGISTRY.mesh_executor_for(format_name)
        if sharded is not None:
            return sharded
    if requested in REGISTRY and REGISTRY.consumes(requested) == format_name:
        return requested
    mapped = _FORMAT_EXECUTORS[format_name]
    return requested if mapped is None else mapped


def choose_format(
    phi: PhiTensor,
    dictionary: torch.Tensor,
    *,
    row_tile: int = DEFAULT_ROW_TILE,
    slot_tile: int = DEFAULT_SLOT_TILE,
    allowed: Tuple[str, ...] = DEFAULT_CANDIDATES,
    sell_accept: float = DEFAULT_SELL_ACCEPT,
    sell_reject: float = DEFAULT_SELL_REJECT,
    coo_executor: str = "opt",
    c_tile: int = DEFAULT_C_TILE,
    cache=None,
    predictor=None,
) -> FormatPlan:
    """Pick a Phi format for one dataset (the ladder of the module
    docstring).  ``coo_executor`` (and, for ``"kernel"``, ``c_tile``) is
    what the coo candidate is timed on."""
    if not allowed:
        raise ValueError("allowed must name at least one format")
    decide = functools.partial(
        _decide_format, phi, dictionary, allowed=allowed, row_tile=row_tile,
        slot_tile=slot_tile, sell_accept=sell_accept,
        sell_reject=sell_reject, coo_executor=coo_executor, c_tile=c_tile)
    key = None
    if cache is not None and cache.enabled:
        from repro_torch.core.plan_cache import format_plan_key
        key = format_plan_key(
            to_numpy(phi.atoms), to_numpy(phi.voxels), to_numpy(phi.fibers),
            sizes=(phi.n_atoms, phi.n_voxels, phi.n_fibers),
            row_tile=row_tile, slot_tile=slot_tile, allowed=allowed,
            backend=phi.device.type, coo_executor=coo_executor,
            sell_accept=sell_accept, sell_reject=sell_reject)
        plan = cache.get_format_plan(key)
        if plan is not None:
            if plan.reason == "predicted":
                # a predicted entry still serving hits was never refined (a
                # process restart dropped the queue): queue it again
                _enqueue_refinement(key, cache, decide)
            return plan

    stats = phi_stats(phi, row_tile=row_tile, slot_tile=slot_tile)
    params = dict(row_tile=row_tile, slot_tile=slot_tile)
    if predictor is not None:
        with obs.span("select.predicted") as sp:
            fmt = predictor.predict_format(stats, allowed=allowed)
            sp.set_attr("format", fmt)
        if fmt is not None:
            obs.counter("learn.predict", kind="format", outcome="hit").inc()
            plan = FormatPlan(fmt, "predicted", params, stats)
            if key is not None:
                cache.put_format_plan(key, plan)
                _enqueue_refinement(key, cache, decide)
            return plan
        obs.counter("learn.predict", kind="format",
                    outcome="fallback").inc()

    plan = decide(stats)
    if key is not None:
        cache.put_format_plan(key, plan)
    return plan


def _enqueue_refinement(key: str, cache, decide) -> None:
    """Queue the heuristic and measured rungs to overwrite a predicted
    plan in place."""
    from repro_torch.learn import refine

    def _task() -> None:
        cache.put_format_plan(key, decide(None))

    refine.QUEUE.push("format", key, _task)


def _decide_format(phi, dictionary, stats, *, allowed, row_tile, slot_tile,
                   sell_accept, sell_reject, coo_executor,
                   c_tile) -> FormatPlan:
    """Heuristic and measured rungs of the ladder (no cache, no
    predictor); ``stats=None`` computes them.  Background refinement
    re-runs exactly this under the same thresholds."""
    if stats is None:
        stats = phi_stats(phi, row_tile=row_tile, slot_tile=slot_tile)
    params = dict(row_tile=row_tile, slot_tile=slot_tile)
    overhead = max(stats["dsc.sell_overhead"], stats["wc.sell_overhead"])
    candidates = tuple(allowed)
    # strike SELL on heavy skew, unless it is the only candidate the caller
    # permits, in which case the caller's constraint wins
    if "sell" in candidates and overhead >= sell_reject and len(candidates) > 1:
        candidates = tuple(f for f in candidates if f != "sell")
    if "sell" in candidates and overhead <= sell_accept:
        return FormatPlan("sell", "heuristic", params, stats)
    if len(candidates) == 1:
        return FormatPlan(candidates[0], "heuristic", params, stats)
    return FormatPlan(_measure_formats(phi, dictionary, candidates,
                                       row_tile, slot_tile, coo_executor,
                                       c_tile),
                      "autotune", params, stats)


def _measure_formats(phi: PhiTensor, dictionary: torch.Tensor,
                     allowed: Tuple[str, ...], row_tile: int,
                     slot_tile: int, coo_executor: str = "opt",
                     c_tile: int = DEFAULT_C_TILE) -> str:
    """Measured rung: time the DSC each candidate's executor runs, through
    restructure.autotune_plan's measurement loop."""
    from types import SimpleNamespace
    from repro_torch.core.registry import REGISTRY
    from repro_torch.kernels import ops as kops
    w_probe = torch.ones((phi.n_fibers,), dtype=dictionary.dtype,
                         device=dictionary.device)
    # an untuned fp32 build: selection must not recurse into the tuner
    untuned = SimpleNamespace(compute_dtype="fp32", tune="off",
                              c_tile=c_tile, row_tile=row_tile)

    def sorter(p: PhiTensor, fmt: str):
        if fmt == "sell":
            return kops.make_dsc_sell(
                SellPhi.encode(p, op="dsc", row_tile=row_tile,
                               slot_tile=slot_tile), dictionary), None
        if fmt == "fcoo":
            matvec, _ = kops.make_fcoo_ops(FcooPhi.encode(p), dictionary)
            return matvec, None
        # alto and coo: the registry's executor, so each is charged what
        # its DSC really costs (coo on the executor that would run it)
        ex = REGISTRY.create("alto" if fmt == "alto" else coo_executor, p,
                             SimpleNamespace(dictionary=dictionary), untuned)
        return ex.matvec, None

    def run(matvec, fmt: str):
        return matvec(w_probe)

    plan = autotune_plan("dsc", phi, run, candidates=tuple(allowed),
                         sorter=sorter)
    return plan.restructure                        # holds the format name


def resolve_format(phi: PhiTensor, problem, config, cache=None,
                   allowed: Optional[Tuple[str, ...]] = None,
                   mesh_aware: bool = True) -> FormatPlan:
    """Engine entry point: honour an explicit ``config.format`` or select.

    ``allowed`` restricts the candidate set (the batched engine passes the
    formats that stack across subjects: SELL widths are per-subject
    shapes).  Under a multi-cell mesh request (``shard_rows * shard_cols >
    1``) the "auto" candidates are further cut to the formats with a
    registered mesh executor: selecting alto would drop the requested
    partition.  ``mesh_aware=False`` keeps the full set, for callers to
    which the mesh fields mean placement only (the batched engine).

    Raises:
        ValueError: an unknown format, an explicit format outside
            ``allowed``, or a mesh request none of whose candidates has a
            mesh executor.
    """
    fmt = config.format
    row_tile, slot_tile = config.row_tile, config.slot_tile
    if fmt != "auto":
        if fmt not in _FORMAT_EXECUTORS:
            raise ValueError(
                f"format must be one of {format_names() + ('auto',)}, "
                f"got {fmt!r}")
        if allowed is not None and fmt not in allowed:
            raise ValueError(
                f"format {fmt!r} is not supported here (allowed: {allowed})")
        return FormatPlan(fmt, "explicit",
                          dict(row_tile=row_tile, slot_tile=slot_tile))
    candidates = (tuple(allowed) if allowed is not None
                  else DEFAULT_CANDIDATES)
    if mesh_aware and _mesh_cells(config) > 1:
        from repro_torch.core.registry import REGISTRY
        mesh_ok = tuple(f for f in candidates
                        if REGISTRY.mesh_executor_for(f) is not None)
        if not mesh_ok:
            raise ValueError(
                f"no candidate format in {candidates} has a mesh executor "
                f"(shard_rows x shard_cols = {_mesh_cells(config)})")
        candidates = mesh_ok
    predictor = None
    if config.predict != "off" and cache is not None and cache.enabled:
        from repro_torch.learn import load_predictor
        predictor = load_predictor(cache.directory)
    return choose_format(
        phi, problem.dictionary, row_tile=row_tile, slot_tile=slot_tile,
        allowed=candidates,
        sell_accept=config.sell_accept, sell_reject=config.sell_reject,
        coo_executor=executor_for("coo", config), c_tile=config.c_tile,
        cache=cache, predictor=predictor)
