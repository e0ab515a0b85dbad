"""Batched multi-subject LiFE: one SBBNNLS over a subject cohort.

Torch counterpart of ``repro/core/batched.py``.  Production LiFE serves
many subjects against one shared diffusion dictionary (the canonical atoms
depend on the gradient scheme, not the subject).  Per subject the workload
has the same structure (the same Nv voxel grid, Nf candidate fibers and
Ntheta directions), but each Phi has its own coefficient count Nc_s.  This
engine:

  1. restructures every subject's Phi per the chosen executor (the same
     per-op sorts :mod:`repro_torch.core.registry` applies for one
     subject),
  2. pads each subject's coefficients to the cohort max Nc with inert
     dummy slots: value 0, so padding adds nothing through either SpMV,
     and sort key = the last index of that dimension, so the padded tail
     keeps the order the segment sums rely on,
  3. lays the cohort out as one stream with subject offsets (voxel ``v``
     of subject ``s`` is row ``s * Nv + v``, fiber ``f`` is
     ``s * Nf + f``), so each SpMV of an iteration runs once for the whole
     cohort, and steps every subject with its own Barzilai-Borwein step
     size (:func:`repro_torch.core.sbbnnls.batched_step`).

The reference vmaps its jnp executors over ``(S, Nc_max)`` stacked
operands instead; the padded per-subject blocks of the offset stream are
those stacked operands laid end to end, and the offsets keep the padded
stream sorted where each block is.  Executors whose operands are
per-subject layouts (the ``kernel*`` executors, ``alto`` by name) are
refused, as the reference refuses its Pallas executors; ``format="alto"``
orders each subject's coefficients by ALTO and runs the scatter ops.
Batching composes with the plan cache: the ``auto`` path measures once on
the first subject and applies the choice cohort-wide.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import spmv
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.registry import _DSC_FNS, _WC_FNS, REGISTRY
from repro_torch.core.restructure import sort_by_host
from repro_torch.core.sbbnnls import (SbbnnlsState, batched_init,
                                      batched_steps)
from repro_torch.core.std import PhiTensor
from repro_torch.data.dmri import LifeProblem
from repro_torch.device import DeviceLike, fence, resolve_device

# executor name -> (dsc sort dim or None, wc sort dim or None, dsc fn, wc fn)
_BATCH_RECIPES = {
    "naive": (None, None, spmv.dsc_naive, spmv.wc_naive),
    "opt": ("voxel", "fiber", spmv.dsc, spmv.wc),
    "opt-paper": ("voxel", "atom", spmv.dsc, spmv.wc_atom_sorted),
}

# (fn, dim) pairs whose fn is a *sorted* segment reduction over dim;
# padding must extend the sort key monotonically for these
_SEGMENT_SORTED = {(spmv.dsc, "voxel"), (spmv.wc, "fiber")}


def _pad_sorted(phi: PhiTensor, nc_max: int, sort_dim: Optional[str],
                keep_sorted: bool) -> PhiTensor:
    """Pad a (possibly sorted) PhiTensor to nc_max inert dummy
    coefficients."""
    pad = nc_max - phi.n_coeffs
    if pad == 0:
        return phi
    dim_last = {"atom": phi.n_atoms - 1, "voxel": phi.n_voxels - 1,
                "fiber": phi.n_fibers - 1}

    def pad_idx(arr, dim):
        fill = dim_last[dim] if (keep_sorted and dim == sort_dim) else 0
        return torch.cat([arr, arr.new_full((pad,), fill)])

    return dataclasses.replace(
        phi,
        atoms=pad_idx(phi.atoms, "atom"),
        voxels=pad_idx(phi.voxels, "voxel"),
        fibers=pad_idx(phi.fibers, "fiber"),
        values=torch.cat([phi.values, phi.values.new_zeros((pad,))]))


def _stack_phis(phis: Sequence[PhiTensor]) -> PhiTensor:
    """One stream of the subjects' Phis with subject offsets: voxel ``v``
    of subject ``s`` becomes ``s * Nv + v`` and fiber ``f`` becomes
    ``s * Nf + f`` (atoms index the shared dictionary)."""
    p0 = phis[0]
    nv, nf = p0.n_voxels, p0.n_fibers
    return dataclasses.replace(
        p0,
        atoms=torch.cat([p.atoms for p in phis]),
        voxels=torch.cat([p.voxels + s * nv for s, p in enumerate(phis)]),
        fibers=torch.cat([p.fibers + s * nf for s, p in enumerate(phis)]),
        values=torch.cat([p.values for p in phis]),
        n_voxels=len(phis) * nv, n_fibers=len(phis) * nf)


def _bind(fn, phi: PhiTensor, d: torch.Tensor):
    """``x -> fn(phi, d, x)``, with the run lengths of a segment sum
    computed once here (inspector work) rather than every call."""
    if fn is spmv.dsc:
        lengths = spmv.segment_lengths(phi.voxels, phi.n_voxels)
        return lambda x: fn(phi, d, x, lengths)
    if fn is spmv.wc:
        lengths = spmv.segment_lengths(phi.fibers, phi.n_fibers)
        return lambda x: fn(phi, d, x, lengths)
    return lambda x: fn(phi, d, x)


class BatchedLifeEngine:
    """Runs SBBNNLS for a cohort of subjects at once on one device.

    All subjects must share the dictionary and the (Nv, Nf) geometry;
    coefficient counts may differ (padded to the cohort max).  ``device``
    defaults to the CUDA card (:func:`repro_torch.device.resolve_device`).
    """

    def __init__(self, problems: Sequence[LifeProblem], config,
                 cache: Optional[PlanCache] = None, *,
                 device: DeviceLike = None):
        if not problems:
            raise ValueError("need at least one subject")
        self.device = resolve_device(device)
        self.problems = [p.to(self.device) for p in problems]
        self.config = config
        self.cache = cache if cache is not None else PlanCache(
            getattr(config, "plan_cache_dir", None),
            getattr(config, "plan_cache_max_bytes", None))
        self.format_plan = None       # set when config.format != "coo"
        self.tune_plan = None         # set when config.tune != "off"
        from repro_torch.tune.tuner import validate_config as _validate_tune
        _validate_tune(config)
        if getattr(config, "compact_every", 0) > 0:
            raise ValueError(
                "weight compaction is per-subject (changes Nc mid-run) and "
                "is not supported by the batched engine; use LifeEngine")
        if (getattr(config, "shard_rows", 1)
                * getattr(config, "shard_cols", 1) > 1):
            raise ValueError("shard_rows x shard_cols > 1 is not ported yet: "
                             "the cohort's mesh placement is still to come "
                             "(ROADMAP A13)")
        p0 = self.problems[0]
        for p in self.problems[1:]:
            if (p.phi.n_voxels, p.phi.n_fibers) != (p0.phi.n_voxels,
                                                    p0.phi.n_fibers):
                raise ValueError("subjects must share (Nv, Nf) geometry")
            if not torch.equal(p.dictionary, p0.dictionary):
                raise ValueError("subjects must share the dictionary "
                                 "(same gradient scheme and atoms)")
        self.dictionary = p0.dictionary
        self.n_subjects = len(self.problems)
        self.inspector_seconds = 0.0
        self._build()

    # -- inspector ----------------------------------------------------------
    def _resolve_recipe(self):
        name = self.config.executor
        fmt = getattr(self.config, "format", "coo")
        self._alto_order = False
        if fmt != "coo":
            # only COO and ALTO stack across subjects (SELL widths and
            # F-COO chunk maps are per-subject layouts); "auto" picks
            # between them on the first subject (FormatPlan-cached)
            from repro_torch.formats import select as fsel
            self.format_plan = fsel.resolve_format(
                self.problems[0].phi, self.problems[0], self.config,
                self.cache, allowed=("coo", "alto"), mesh_aware=False)
            if self.format_plan.format == "alto":
                self._alto_order = True
                return None, None, spmv.dsc_naive, spmv.wc_naive
        if name in _BATCH_RECIPES:
            return _BATCH_RECIPES[name]
        if name == "auto":
            # measure once on the first subject (through the persistent
            # cache), apply the choice cohort-wide
            ex = REGISTRY.create("auto", self.problems[0].phi,
                                 self.problems[0], self.config, self.cache)
            dsc_dim = ex.plans["dsc"].restructure
            wc_dim = ex.plans["wc"].restructure
            return dsc_dim, wc_dim, _DSC_FNS[dsc_dim], _WC_FNS[wc_dim]
        raise ValueError(
            f"executor {name!r} is not vmappable across subjects "
            f"(supported: {sorted(_BATCH_RECIPES) + ['auto']})")

    def _resolve_tuning(self) -> str:
        """Resolve the tune plan on the first subject (persistent-cached);
        returns the storage dtype the stacked operands are built under.

        The batched recipes are plain PyTorch (no layout axes), so the
        searched axis that reaches this engine is the compute dtype.  The
        same resolver keeps the plan-cache entry shared with a
        single-subject engine on the same dataset and backend."""
        cfg = self.config
        if getattr(cfg, "tune", "off") == "off":
            cd = getattr(cfg, "compute_dtype", "fp32")
            return "fp32" if cd == "auto" else cd
        from repro_torch.tune.tuner import resolve_plan
        self.tune_plan = resolve_plan(cfg.executor, self.problems[0].phi,
                                      self.problems[0], cfg, self.cache)
        return self.tune_plan.compute_dtype

    def _build(self) -> None:
        t0 = time.perf_counter()
        self._compute_dtype = self._resolve_tuning()
        dsc_dim, wc_dim, dsc_fn, wc_fn = self._resolve_recipe()
        nc_max = max(p.phi.n_coeffs for p in self.problems)
        self.nc_padded = nc_max

        def prep(phi: PhiTensor, dim: Optional[str], fn) -> PhiTensor:
            sorted_phi = sort_by_host(phi, dim)[0] if dim else phi
            keep_sorted = (fn, dim) in _SEGMENT_SORTED
            return _pad_sorted(sorted_phi, nc_max, dim, keep_sorted)

        phis = [p.phi for p in self.problems]
        if self._alto_order:
            # one ALTO-linearized order per subject serves both ops
            from repro_torch.formats.alto import AltoPhi
            phis = [AltoPhi.encode(phi).sort()[0].decode() for phi in phis]

        self.phi_dsc = _stack_phis([prep(phi, dsc_dim, dsc_fn)
                                    for phi in phis])
        self.phi_wc = _stack_phis([prep(phi, wc_dim, wc_fn) for phi in phis])
        self.b = torch.stack([p.b for p in self.problems])
        d = self.dictionary
        if self._compute_dtype == "bf16":
            # bf16 storage of the static operands (Phi values and the
            # shared dictionary); w, Y and b stay fp32, so every product
            # promotes to fp32 before the reductions
            self.phi_dsc = self.phi_dsc.astype(torch.bfloat16)
            self.phi_wc = self.phi_wc.astype(torch.bfloat16)
            d = d.to(torch.bfloat16)
        s, nv, nf = self.n_subjects, phis[0].n_voxels, phis[0].n_fibers
        dsc_op = _bind(dsc_fn, self.phi_dsc, d)
        wc_op = _bind(wc_fn, self.phi_wc, d)
        self._matvec = lambda w: dsc_op(w.reshape(s * nf)).reshape(s, nv, -1)
        self._rmatvec = lambda y: wc_op(y.reshape(s * nv, -1)).reshape(s, nf)
        self.inspector_seconds += time.perf_counter() - t0

    @property
    def resolved_compute_dtype(self) -> str:
        """Storage dtype the stacked operands were built under (the tune
        plan's winner when ``compute_dtype="auto"`` was searched)."""
        return self._compute_dtype

    # -- driver --------------------------------------------------------------
    def init_states(self, w0: Optional[torch.Tensor] = None) -> SbbnnlsState:
        """Fresh per-subject solver states stacked along axis 0: ``w``
        ``(S, Nf)``, ``it`` a host array of ``S`` counters, ``loss``
        ``(S,)``."""
        nf = self.problems[0].phi.n_fibers
        if w0 is None:
            w0 = torch.ones((self.n_subjects, nf),
                            dtype=self.dictionary.dtype, device=self.device)
        return batched_init(w0.to(self.device))

    def step(self, states: SbbnnlsState, k: int
             ) -> Tuple[SbbnnlsState, torch.Tensor]:
        """Advance every subject's state by ``k`` iterations (stepped API).

        Per-subject iteration counters ride in the state, so subjects
        restored from a checkpoint keep their own Barzilai-Borwein parity
        and chained calls match one uninterrupted run exactly.  Returns
        (states, ``(S, k)`` loss trace on the device).  While
        observability is on, the ``engine.step`` span and histogram time
        the call between two fences of the card."""
        if not obs.SWITCH.on:
            return batched_steps(self._matvec, self._rmatvec, self.b,
                                 states, k)
        with obs.span("engine.step", {"executor": self.config.executor,
                                      "batched": self.n_subjects, "k": k}):
            fence(self.device)
            t0 = time.perf_counter()
            new, losses = batched_steps(self._matvec, self._rmatvec, self.b,
                                        states, k)
            fence(self.device)
            obs.histogram("engine.step.seconds",
                          executor=self.config.executor).observe(
                time.perf_counter() - t0)
        return new, losses

    def run(self, n_iters: Optional[int] = None,
            w0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Solve all subjects; returns (W ``(S, Nf)``, losses
        ``(S, n_iters)``), both on the device."""
        n_iters = self.config.n_iters if n_iters is None else n_iters
        final, losses = self.step(self.init_states(w0), n_iters)
        return final.w, losses

    def prune_stats(self, w_batch: torch.Tensor,
                    threshold: float = 1e-6) -> List[dict]:
        """Support recovery of each subject against its ``w_true > 0``."""
        out = []
        for p, w in zip(self.problems,
                        w_batch.detach().float().cpu().numpy()):
            true = p.w_true.detach().float().cpu().numpy() > 0
            kept = w > threshold
            tp = float(np.sum(kept & true))
            out.append(dict(
                kept=float(kept.sum()), total=float(kept.size),
                precision=tp / max(1.0, float(kept.sum())),
                recall=tp / max(1.0, float(true.sum()))))
        return out
