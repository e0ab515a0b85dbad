"""Per-dataset format selection: heuristic first, measurement when unsure.

Torch counterpart of ``repro/formats/select.py`` (Chen et al.,
arXiv:1805.11938: no single SpMV format wins across matrices).  The
decision ladder:

1. **Cache** — the choice is a :class:`~repro_torch.formats.base.FormatPlan`
   keyed by ``plan_cache.format_plan_key`` (full index content, geometry,
   candidate set, thresholds and backend); a warm engine rebuild loads it
   and never selects again.
2. **Heuristic** — from :func:`repro_torch.core.inspector.phi_stats`:
   SELL's padding overhead is known from run lengths without encoding.
   Overhead at most ``sell_accept`` extra slots per coefficient takes SELL
   outright; at least ``sell_reject`` strikes SELL from the candidates.
3. **Measure** — whenever more than one candidate survives, time each
   candidate's DSC (the dominant op, 2 calls per iteration against WC's
   1.5) through ``restructure.autotune_plan``, the same three-run loop as
   the paper's runtime restructuring choice.

The reference has a predict rung between 1 and 2 (a learned predictor
answering a cache miss); it arrives with learned selection (ROADMAP A11),
and until then the port behaves as the reference does with no
``predictor.json`` in the cache directory: ``LifeConfig.predict`` is
accepted and has no effect.

The measured rung times what each candidate's executor runs: kernel B3 for
sell, kernel B5 (which folds its chunks itself) for fcoo, the ``alto``
executor, and the voxel-sorted ``opt`` DSC for coo.  (The reference times its SELL and F-COO
jnp references instead, because off the TPU its kernels run interpreted.)
On CPU tensors each of them is its plain version.

``resolve_format`` is the engine entry point: it honours an explicit
``LifeConfig.format`` (``reason="explicit"``) and maps the chosen format to
the executor registry name.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.bridge import to_numpy
from repro_torch.core.inspector import phi_stats
from repro_torch.core.restructure import autotune_plan, sort_by_host
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

#: default "auto" candidate set (every leaf format)
DEFAULT_CANDIDATES = ("coo", "sell", "alto", "fcoo")


def executor_for(format_name: str, config) -> str:
    """Registry name that runs a format: an explicitly configured executor
    that itself consumes the format, else the format's own executor (COO
    defers to ``config.executor``)."""
    if format_name not in _FORMAT_EXECUTORS:
        raise ValueError(
            f"format must be one of {format_names()}, got {format_name!r}")
    from repro_torch.core.registry import REGISTRY
    requested = config.executor
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
    cache=None,
) -> FormatPlan:
    """Pick a Phi format for one dataset (the ladder of the module
    docstring)."""
    if not allowed:
        raise ValueError("allowed must name at least one format")
    key = None
    if cache is not None and cache.enabled:
        from repro_torch.core.plan_cache import format_plan_key
        key = format_plan_key(
            to_numpy(phi.atoms), to_numpy(phi.voxels), to_numpy(phi.fibers),
            sizes=(phi.n_atoms, phi.n_voxels, phi.n_fibers),
            row_tile=row_tile, slot_tile=slot_tile, allowed=allowed,
            backend=phi.device.type, sell_accept=sell_accept,
            sell_reject=sell_reject)
        plan = cache.get_format_plan(key)
        if plan is not None:
            return plan

    stats = phi_stats(phi, row_tile=row_tile, slot_tile=slot_tile)
    params = dict(row_tile=row_tile, slot_tile=slot_tile)
    plan = _decide_format(phi, dictionary, stats, params, allowed,
                          row_tile=row_tile, slot_tile=slot_tile,
                          sell_accept=sell_accept, sell_reject=sell_reject)
    if key is not None:
        cache.put_format_plan(key, plan)
    return plan


def _decide_format(phi, dictionary, stats, params, allowed, *, row_tile,
                   slot_tile, sell_accept, sell_reject) -> FormatPlan:
    """Heuristic and measured rungs of the ladder (no cache)."""
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
                                       row_tile, slot_tile),
                      "autotune", params, stats)


def _measure_formats(phi: PhiTensor, dictionary: torch.Tensor,
                     allowed: Tuple[str, ...], row_tile: int,
                     slot_tile: int) -> str:
    """Measured rung: time the DSC each candidate's executor runs, through
    restructure.autotune_plan's measurement loop."""
    from repro_torch.core import spmv
    from repro_torch.kernels import ops as kops
    w_probe = torch.ones((phi.n_fibers,), dtype=dictionary.dtype,
                         device=dictionary.device)

    def sorter(p: PhiTensor, fmt: str):
        if fmt == "sell":
            return kops.make_dsc_sell(
                SellPhi.encode(p, op="dsc", row_tile=row_tile,
                               slot_tile=slot_tile), dictionary), None
        if fmt == "alto":
            # the registry's executor, so ALTO is charged what its DSC
            # really costs (an untuned build: selection must not recurse)
            from types import SimpleNamespace
            from repro_torch.core.registry import REGISTRY
            ex = REGISTRY.create(
                "alto", p, SimpleNamespace(dictionary=dictionary),
                SimpleNamespace(compute_dtype="fp32"))
            return ex.matvec, None
        if fmt == "fcoo":
            matvec, _ = kops.make_fcoo_ops(FcooPhi.encode(p), dictionary)
            return matvec, None
        phi_v, order = sort_by_host(p, "voxel")           # coo: opt DSC
        lengths = spmv.segment_lengths(phi_v.voxels, phi_v.n_voxels)
        return (lambda w: spmv.dsc(phi_v, dictionary, w, lengths)), order

    def run(matvec, fmt: str):
        return matvec(w_probe)

    plan = autotune_plan("dsc", phi, run, candidates=tuple(allowed),
                         sorter=sorter)
    return plan.restructure                        # holds the format name


def resolve_format(phi: PhiTensor, problem, config, cache=None
                   ) -> FormatPlan:
    """Engine entry point: honour an explicit ``config.format`` or select.

    Raises:
        ValueError: an unknown format, or a mesh request
            (``shard_rows * shard_cols > 1``), whose mesh-aware candidate
            set arrives with the mesh slice (ROADMAP A13).
    """
    fmt = config.format
    row_tile, slot_tile = config.row_tile, config.slot_tile
    if config.shard_rows * config.shard_cols > 1:
        raise ValueError("shard_rows x shard_cols > 1 is not ported yet: the "
                         "mesh partition arrives with the mesh slice "
                         "(ROADMAP A13)")
    if fmt != "auto":
        if fmt not in _FORMAT_EXECUTORS:
            raise ValueError(
                f"format must be one of {format_names() + ('auto',)}, "
                f"got {fmt!r}")
        return FormatPlan(fmt, "explicit",
                          dict(row_tile=row_tile, slot_tile=slot_tile))
    return choose_format(
        phi, problem.dictionary, row_tile=row_tile, slot_tile=slot_tile,
        allowed=DEFAULT_CANDIDATES, sell_accept=config.sell_accept,
        sell_reject=config.sell_reject, cache=cache)
