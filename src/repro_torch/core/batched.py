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

Mesh placement: with ``shard_rows * shard_cols > 1`` the cohort is laid
out over the ``(data, model)`` mesh the sharded executors use: subjects
over ``data`` and each subject's padded coefficient slots over ``model``.
The reference places its stacked ``(S, Nc_max)`` operands so and lets
GSPMD partition the vmapped solve; here mesh row ``r`` solves its
subjects, and cell ``(r, c)`` holds the ``c``-th contiguous slot range of
each of them, whose partial SpMV results are summed over ``model`` with
the mesh's ``psum``.  The mesh is a
:class:`~repro_torch.distributed.mesh.ProcessGroupMesh` when this process
is one of ``R * C`` ranks (each rank its cell, the rows' weights summed
over ``data`` at the end), else a
:class:`~repro_torch.distributed.mesh.LocalMesh` (every cell here).  An
axis that does not divide its mesh axis stays replicated.  Results equal
the unplaced solve's up to the order of the partial sums.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ops import tensor_bytes

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

    with obs.span("build.upload") as sp:
        out = dataclasses.replace(
            phi,
            atoms=pad_idx(phi.atoms, "atom"),
            voxels=pad_idx(phi.voxels, "voxel"),
            fibers=pad_idx(phi.fibers, "fiber"),
            values=torch.cat([phi.values, phi.values.new_zeros((pad,))]))
        sp.set_attr("bytes", tensor_bytes(
            out.atoms, out.voxels, out.fibers, out.values))
    return out


def _stack_phis(phis: Sequence[PhiTensor]) -> PhiTensor:
    """One stream of the subjects' Phis with subject offsets: voxel ``v``
    of subject ``s`` becomes ``s * Nv + v`` and fiber ``f`` becomes
    ``s * Nf + f`` (atoms index the shared dictionary)."""
    p0 = phis[0]
    nv, nf = p0.n_voxels, p0.n_fibers
    with obs.span("build.upload") as sp:
        out = dataclasses.replace(
            p0,
            atoms=torch.cat([p.atoms for p in phis]),
            voxels=torch.cat([p.voxels + s * nv
                              for s, p in enumerate(phis)]),
            fibers=torch.cat([p.fibers + s * nf
                              for s, p in enumerate(phis)]),
            values=torch.cat([p.values for p in phis]),
            n_voxels=len(phis) * nv, n_fibers=len(phis) * nf)
        sp.set_attr("bytes", tensor_bytes(
            out.atoms, out.voxels, out.fibers, out.values))
    return out


def _slots(phi: PhiTensor, a: int, b: int) -> PhiTensor:
    """Slots ``[a, b)`` of a (padded) Phi: a sorted stream's slice stays
    sorted."""
    return dataclasses.replace(phi, atoms=phi.atoms[a:b],
                               voxels=phi.voxels[a:b],
                               fibers=phi.fibers[a:b],
                               values=phi.values[a:b])


def _ops(phi_dsc: PhiTensor, phi_wc: PhiTensor, dsc_fn, wc_fn,
         d: torch.Tensor, s: int):
    """The cohort's matvec ``(s, Nf) -> (s, Nv, Ntheta)`` and rmatvec over
    an offset stream of ``s`` subjects."""
    nv, nf = phi_dsc.n_voxels // s, phi_dsc.n_fibers // s
    dsc_op = _bind(dsc_fn, phi_dsc, d)
    wc_op = _bind(wc_fn, phi_wc, d)
    return (lambda w: dsc_op(w.reshape(s * nf)).reshape(s, nv, -1),
            lambda y: wc_op(y.reshape(s * nv, -1)).reshape(s, nf))


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
    ``mesh``: place the cohort on this mesh (a ``LocalMesh`` or
    ``ProcessGroupMesh``, even of one cell) instead of the one
    ``shard_rows`` x ``shard_cols`` asks for.  On a mesh each process
    prepares only the subjects its rows solve and holds its cells' slots;
    the whole stacked operands ``phi_dsc`` / ``phi_wc`` exist only
    unplaced.
    """

    def __init__(self, problems: Sequence[LifeProblem], config,
                 cache: Optional[PlanCache] = None, *,
                 device: DeviceLike = None, mesh=None):
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
        self.mesh = self._make_mesh() if mesh is None else mesh
        self._build()

    def _make_mesh(self):
        """The ``(data, model)`` mesh when the config asks for more than
        one cell: the process group's
        :class:`~repro_torch.distributed.mesh.ProcessGroupMesh` when this
        process is one of ``R * C`` ranks, else a
        :class:`~repro_torch.distributed.mesh.LocalMesh`.

        Raises:
            ValueError: a local mesh of more cells than the device admits.
        """
        R = getattr(self.config, "shard_rows", 1)
        C = getattr(self.config, "shard_cols", 1)
        if R * C <= 1:
            return None
        import torch.distributed as dist
        from repro_torch.distributed import mesh as DM
        if (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() == R * C):
            return DM.ProcessGroupMesh(R, C, device=self.device)
        have = DM.max_cells(self.device)
        if R * C > have:
            raise ValueError(f"batched mesh needs {R * C} devices, "
                             f"have {have}")
        return DM.LocalMesh(R, C, self.device, name="batched mesh")

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
        with obs.timed("engine.build", {
                "executor": self.config.executor,
                "format": getattr(self.config, "format", "coo"),
                "n_coeffs": sum(p.phi.n_coeffs for p in self.problems),
                "subjects": self.n_subjects}) as sp:
            self._build_operands()
        self.inspector_seconds += sp.duration_s

    def _build_operands(self) -> None:
        self._compute_dtype = self._resolve_tuning()
        dsc_dim, wc_dim, dsc_fn, wc_fn = self._resolve_recipe()
        nc_max = max(p.phi.n_coeffs for p in self.problems)
        self.nc_padded = nc_max

        def prep(phi: PhiTensor, dim: Optional[str], fn) -> PhiTensor:
            sorted_phi = sort_by_host(phi, dim)[0] if dim else phi
            keep_sorted = (fn, dim) in _SEGMENT_SORTED
            return _pad_sorted(sorted_phi, nc_max, dim, keep_sorted)

        # on a mesh, only the subjects this process's rows solve are
        # prepared, and no whole stacked Phi is built
        held = (range(self.n_subjects) if self.mesh is None
                else self._held_subjects())
        phis = {s: self.problems[s].phi for s in held}
        if self._alto_order:
            # one ALTO-linearized order per subject serves both ops
            from repro_torch.formats.alto import AltoPhi
            phis = {s: AltoPhi.encode(phi).sort()[0].decode()
                    for s, phi in phis.items()}

        dsc_parts = {s: prep(phi, dsc_dim, dsc_fn) for s, phi in phis.items()}
        wc_parts = {s: prep(phi, wc_dim, wc_fn) for s, phi in phis.items()}
        self.b = torch.stack([p.b for p in self.problems])
        d = self.dictionary
        if self._compute_dtype == "bf16":
            # bf16 storage of the static operands (Phi values and the
            # shared dictionary); w, Y and b stay fp32, so every product
            # promotes to fp32 before the reductions
            dsc_parts = {s: p.astype(torch.bfloat16)
                         for s, p in dsc_parts.items()}
            wc_parts = {s: p.astype(torch.bfloat16)
                        for s, p in wc_parts.items()}
            d = d.to(torch.bfloat16)
        if self.mesh is not None:
            self._place_on_mesh(dsc_parts, wc_parts, dsc_fn, wc_fn, d)
        else:
            self.phi_dsc = _stack_phis(list(dsc_parts.values()))
            self.phi_wc = _stack_phis(list(wc_parts.values()))
            self._matvec, self._rmatvec = _ops(self.phi_dsc, self.phi_wc,
                                               dsc_fn, wc_fn, d,
                                               self.n_subjects)

    def _held_subjects(self) -> Sequence[int]:
        """The subjects the mesh rows of this process's cells solve: a row's
        block when the subjects divide over ``data``, else all."""
        S, R = self.n_subjects, self.mesh.shape[0]
        if S % R:
            return range(S)
        rows = sorted({r for r, _ in self.mesh.cells})
        n = S // R
        return [s for r in rows for s in range(r * n, (r + 1) * n)]

    def _place_on_mesh(self, dsc_parts, wc_parts, dsc_fn, wc_fn, d) -> None:
        """Subjects over ``data``, the stacked Phi slots over ``model``: mesh
        row ``r`` solves its block of subjects, and its cell ``(r, c)``
        holds the ``c``-th contiguous slot range of each of them, so each
        SpMV's partial ``y`` / ``w`` is reduced with ``psum`` over
        ``model``.  An axis that does not divide its mesh axis stays
        replicated (every row solves every subject; every cell holds every
        slot, and no psum runs)."""
        mesh, S = self.mesh, self.n_subjects
        R, C = mesh.shape
        nc = self.nc_padded
        self.subjects_sharded = S % R == 0
        self.slots_sharded = nc % C == 0
        s_rows = S // R if self.subjects_sharded else S
        n_slots = nc // C if self.slots_sharded else nc

        def cell_phi(parts, r, c):
            lo = r * s_rows if self.subjects_sharded else 0
            a = c * n_slots if self.slots_sharded else 0
            return _stack_phis([_slots(parts[s], a, a + n_slots)
                                for s in range(lo, lo + s_rows)])

        self._cells = {}
        for r, c in mesh.cells:
            dev = mesh.device_of(r, c)
            self._cells[(r, c)] = _ops(
                cell_phi(dsc_parts, r, c).to(dev),
                cell_phi(wc_parts, r, c).to(dev), dsc_fn, wc_fn, d.to(dev),
                s_rows)
        self._s_rows = s_rows

    def _row_ops(self, r: int, cells):
        """Row ``r``'s matvec and rmatvec over its subjects' block: the
        partial products of its ``cells`` (those this process holds)
        summed over ``model``."""
        mesh = self.mesh

        def reduce(parts):
            if not self.slots_sharded:
                return parts[cells[0]]
            return mesh.psum(parts, "model")[r]

        def matvec(w):
            return reduce({rc: self._cells[rc][0](w.to(
                mesh.device_of(*rc))) for rc in cells})

        def rmatvec(y):
            return reduce({rc: self._cells[rc][1](y.to(
                mesh.device_of(*rc))) for rc in cells})
        return matvec, rmatvec

    def _mesh_steps(self, states: SbbnnlsState, k: int
                    ) -> Tuple[SbbnnlsState, torch.Tensor]:
        """:func:`batched_steps` of each mesh row this process holds on its
        subjects; the rows' results assembled into the cohort's (over
        ``data`` between processes)."""
        mesh, S, n = self.mesh, self.n_subjects, self._s_rows
        rows = sorted({r for r, _ in mesh.cells})
        if not self.subjects_sharded:
            rows = rows[:1]
        w = torch.zeros_like(states.w)
        loss = torch.zeros_like(states.loss)
        losses = states.w.new_zeros((S, k))
        for r in rows:
            lo = r * n if self.subjects_sharded else 0
            cells = [rc for rc in mesh.cells if rc[0] == r]
            mv, rmv = self._row_ops(r, cells)
            dev = mesh.device_of(*cells[0])
            part = SbbnnlsState(w=states.w[lo:lo + n].to(dev),
                                it=states.it[lo:lo + n],
                                loss=states.loss[lo:lo + n].to(dev))
            new, ls = batched_steps(mv, rmv, self.b[lo:lo + n].to(dev),
                                    part, k)
            w[lo:lo + n] = new.w.to(w.device)
            loss[lo:lo + n] = new.loss.to(loss.device)
            losses[lo:lo + n] = ls.to(losses.device)
        if self.subjects_sharded and len(rows) < mesh.shape[0]:
            rc = mesh.cells[0]
            w = mesh.psum({rc: w}, "data")[rc[1]]
            loss = mesh.psum({rc: loss}, "data")[rc[1]]
            losses = mesh.psum({rc: losses}, "data")[rc[1]]
        return SbbnnlsState(w=w, it=np.asarray(states.it) + k,
                            loss=loss), losses

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
        observability is on, the ``engine.step`` span and histogram take
        the call's device seconds (:func:`repro_torch.obs.timed_step`)."""
        if not obs.SWITCH.on:
            return self._steps(states, k)
        with obs.timed_step(self.device, {"executor": self.config.executor,
                                          "batched": self.n_subjects,
                                          "k": k},
                            obs.histogram("engine.step.seconds",
                                          executor=self.config.executor)):
            return self._steps(states, k)

    def _steps(self, states: SbbnnlsState, k: int):
        if self.mesh is not None:
            return self._mesh_steps(states, k)
        return batched_steps(self._matvec, self._rmatvec, self.b, states, k)

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
