"""Shard: partitioned Phi layout — (R x C) mesh cells of an inner format.

Torch counterpart of ``repro/formats/shard.py``, the 2-D mesh partition of
the paper's computation partitioning (§4.1.3) as a layout:

  * :func:`partition_cuts` turns the equal-nnz coefficient boundaries of
    ``core/inspector.py:shard_boundaries`` into *id-space* voxel/fiber
    range cuts (a :class:`~repro_torch.core.inspector.ShardPlan`, kept in
    the persistent plan cache under a key that carries the mesh shape, the
    inner cell format, the backend and the device count),
  * :meth:`ShardPhi.encode` materializes every (voxel-range x fiber-range)
    cell on a *localized* cell PhiTensor: ``SellPhi.encode`` for the SELL
    kernels B3/B4, the stable output-dim sort of the COO executors (on the
    host, with no device round trip per cell) for the segment-sum cells;
    then it stacks the cells into common-shape operands whose padding
    slots carry value 0 and are inert through both ops,
  * :meth:`ShardPhi.decode` inverts each cell through the inner format and
    re-globalizes the indices, so the coefficient multiset round-trips.

``ShardPhi.arrays`` are numpy, as in the reference, so a test compares the
two packages' arrays one for one; the executors upload them
(``distributed/life_shard.py``).  ``ShardPhi`` is not in the ``FORMATS``
registry: the selector and the conformance matrix see the executors that
consume it (``shard`` over inner COO, ``shard-sell`` over inner SELL).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional

import numpy as np
import torch

from repro_torch.bridge import to_numpy
from repro_torch.core.inspector import ShardPlan, shard_boundaries
from repro_torch.core.std import PhiTensor
from repro_torch.formats.base import OUTPUT_DIMS
from repro_torch.formats.sell import (DEFAULT_ROW_TILE, DEFAULT_SLOT_TILE,
                                      SellPhi)

#: inner per-cell layouts ShardPhi can materialize
CELL_FORMATS = ("coo", "sell")


def _id_cuts(sorted_ids: np.ndarray, n_ids: int, k: int) -> np.ndarray:
    """Coefficient-offset boundaries -> id-space range cuts for one mode.

    A coefficient cut at offset ``i < n`` becomes the id starting the next
    range (``sorted_ids[i]``); only the final cut maps to ``n_ids``.  An
    interior cut of 0 (the smallest id owns at least its shard's whole
    nnz share) therefore yields an empty leading range instead of a
    non-monotone boundary.
    """
    idx_cuts = shard_boundaries(sorted_ids, k)
    n = sorted_ids.size
    cuts = np.asarray(
        [0] + [int(sorted_ids[i]) if i < n else n_ids
               for i in idx_cuts[1:]], np.int64)
    cuts[-1] = n_ids
    return cuts


def partition_cuts(phi: PhiTensor, R: int, C: int, *,
                   cell_format: str = "coo", cache=None) -> ShardPlan:
    """Equal-nnz (voxel x fiber) range cuts snapped to sub-vector boundaries.

    Routed through the persistent plan cache when one is given: the key
    (``plan_cache.shard_plan_key``) covers the index content, the mesh
    shape, the inner cell format, phi's backend and its device count, so a
    warm rebuild on the same topology skips the partitioning.
    """
    if R < 1 or C < 1:
        raise ValueError(f"mesh shape must be positive, got ({R}, {C})")
    atoms, voxels, fibers = (to_numpy(t) for t in
                             (phi.atoms, phi.voxels, phi.fibers))
    key = None
    if cache is not None and cache.enabled:
        from repro_torch.core.plan_cache import shard_plan_key
        from repro_torch.tune.tuner import device_count
        backend = phi.device.type
        key = shard_plan_key(
            atoms, voxels, fibers,
            sizes=(phi.n_atoms, phi.n_voxels, phi.n_fibers), R=R, C=C,
            cell_format=cell_format, backend=backend,
            n_devices=device_count(backend))
        plan = cache.get_shard_plan(key)
        if plan is not None and (plan.R, plan.C) == (R, C):
            return plan
    plan = ShardPlan(
        R=R, C=C,
        voxel_cuts=_id_cuts(np.sort(voxels), phi.n_voxels, R),
        fiber_cuts=_id_cuts(np.sort(fibers), phi.n_fibers, C))
    if key is not None:
        cache.put_shard_plan(key, plan)
    return plan


def _cell_index_sets(voxels: np.ndarray, fibers: np.ndarray,
                     plan: ShardPlan):
    """Per-cell coefficient index sets + counts for one partition (one host
    sweep; both per-op encodes of an executor share it through
    :func:`encode_pair`)."""
    row_of = np.searchsorted(plan.voxel_cuts, voxels, side="right") - 1
    col_of = np.searchsorted(plan.fiber_cuts, fibers, side="right") - 1
    cell_idx: Dict[tuple, np.ndarray] = {}
    cell_nnz = np.zeros((plan.R, plan.C), np.int64)
    for r in range(plan.R):
        for c in range(plan.C):
            idx = np.nonzero((row_of == r) & (col_of == c))[0]
            cell_idx[(r, c)] = idx
            cell_nnz[r, c] = idx.size
    return cell_idx, cell_nnz


def encode_pair(phi: PhiTensor, *, cell_format: str = "coo", R: int = 1,
                C: int = 1, row_tile: int = DEFAULT_ROW_TILE,
                slot_tile: int = DEFAULT_SLOT_TILE,
                plan: Optional[ShardPlan] = None, cache=None):
    """Both per-op layouts (DSC + WC) from one partition sweep: returns
    ``(shard_dsc, shard_wc)`` sharing one ShardPlan and its cell index
    sets, what the mesh executors build."""
    if plan is None:
        plan = partition_cuts(phi, R, C, cell_format=cell_format,
                              cache=cache)
    cells = _cell_index_sets(to_numpy(phi.voxels), to_numpy(phi.fibers),
                             plan)
    common = dict(cell_format=cell_format, plan=plan, row_tile=row_tile,
                  slot_tile=slot_tile, _cells=cells)
    return (ShardPhi.encode(phi, op="dsc", **common),
            ShardPhi.encode(phi, op="wc", **common))


@dataclasses.dataclass
class ShardPhi:
    """Stacked (R x C) cell operands of one op, inner-format encoded.

    ``arrays`` (all numpy, localized indices, padding slots value 0):

      cell_format="coo"  : ``atoms``/``voxels``/``fibers``/``values``,
                           each ``(R, C, nnz_max)``, sorted by the op's
                           output dimension within the cell (the padded
                           tail repeats the last local row id, so the sort
                           key stays monotone for the sorted segment sums;
                           its values are 0, so it is inert);
      cell_format="sell" : ``atoms``/``others``/``values``, each
                           ``(R, C, rows_padded, width)`` blocked-ELL slot
                           arrays (``others`` = fibers for DSC, voxels for
                           WC), plus ``row_nnz`` ``(R, C, n_rows_local)``.

    ``cell_nnz`` is the exact per-cell coefficient count: the decode mask
    and the padding audit.
    """

    name: ClassVar[str] = "shard"

    op: str                              # "dsc" | "wc"
    cell_format: str                     # "coo" | "sell"
    R: int
    C: int
    voxel_cuts: np.ndarray               # int64 (R+1,)
    fiber_cuts: np.ndarray               # int64 (C+1,)
    nv_local: int
    nf_local: int
    n_atoms: int
    n_voxels: int
    n_fibers: int
    arrays: Dict[str, np.ndarray]
    cell_nnz: np.ndarray                 # int64 (R, C)
    row_tile: int = 0                    # SELL geometry (0 for coo cells)
    slot_tile: int = 0

    # -- encode / decode ------------------------------------------------------
    @classmethod
    def encode(cls, phi: PhiTensor, *, op: str = "dsc",
               cell_format: str = "coo", R: int = 1, C: int = 1,
               row_tile: int = DEFAULT_ROW_TILE,
               slot_tile: int = DEFAULT_SLOT_TILE,
               plan: Optional[ShardPlan] = None, cache=None,
               _cells=None, **_params) -> "ShardPhi":
        if cell_format not in CELL_FORMATS:
            raise ValueError(
                f"cell format must be one of {CELL_FORMATS}, "
                f"got {cell_format!r}")
        if plan is None:
            plan = partition_cuts(phi, R, C, cell_format=cell_format,
                                  cache=cache)
        R, C = plan.R, plan.C
        nv_local, nf_local = plan.nv_local, plan.nf_local

        atoms, voxels, fibers, values = (
            to_numpy(t) for t in (phi.atoms, phi.voxels, phi.fibers,
                                  phi.values))
        cell_idx, cell_nnz = (_cell_index_sets(voxels, fibers, plan)
                              if _cells is None else _cells)

        def cell_phi(r: int, c: int) -> PhiTensor:
            """Localized cell tensor on the host (the R*C encode loop pays
            no device round trip per cell)."""
            idx = cell_idx[(r, c)]
            t = torch.from_numpy
            return PhiTensor(
                atoms=t(atoms[idx].astype(np.int32)),
                voxels=t((voxels[idx] - plan.voxel_cuts[r]).astype(np.int32)),
                fibers=t((fibers[idx] - plan.fiber_cuts[c]).astype(np.int32)),
                values=t(values[idx]),
                n_atoms=phi.n_atoms, n_voxels=nv_local, n_fibers=nf_local)

        if cell_format == "coo":
            nnz_max = max(1, int(cell_nnz.max()))
            out = dict(atoms=np.zeros((R, C, nnz_max), np.int32),
                       voxels=np.zeros((R, C, nnz_max), np.int32),
                       fibers=np.zeros((R, C, nnz_max), np.int32),
                       values=np.zeros((R, C, nnz_max), values.dtype))
            # the padded tail extends the op's output-dim sort key
            # monotonically (the sorted segment sums rely on it); value-0
            # slots are inert whatever row they land on
            out_key = "voxels" if OUTPUT_DIMS[op] == "voxel" else "fibers"
            pad_id = max(0, (nv_local if out_key == "voxels"
                             else nf_local) - 1)
            out[out_key] = np.full((R, C, nnz_max), pad_id, np.int32)
            for (r, c), idx in cell_idx.items():
                cp = cell_phi(r, c)
                # the COO executors' restructuring (a stable sort by the
                # op's output dim), applied on the host
                cols = {k: getattr(cp, k).numpy()
                        for k in ("atoms", "voxels", "fibers", "values")}
                order = np.argsort(cols[out_key], kind="stable")
                n = idx.size
                for k, a in cols.items():
                    out[k][r, c, :n] = a[order]
            row_tile = slot_tile = 0
        else:
            cells = {rc: SellPhi.encode(cell_phi(*rc), op=op,
                                        row_tile=row_tile,
                                        slot_tile=slot_tile)
                     for rc in cell_idx}
            width = max(s.width for s in cells.values())
            rows_padded = next(iter(cells.values())).atoms.shape[0]
            n_rows_local = next(iter(cells.values())).n_rows
            out = dict(atoms=np.zeros((R, C, rows_padded, width), np.int32),
                       others=np.zeros((R, C, rows_padded, width), np.int32),
                       values=np.zeros((R, C, rows_padded, width),
                                       values.dtype),
                       row_nnz=np.zeros((R, C, n_rows_local), np.int32))
            for (r, c), s in cells.items():
                w = s.width
                out["atoms"][r, c, :, :w] = s.atoms
                out["others"][r, c, :, :w] = s.others
                out["values"][r, c, :, :w] = s.values
                out["row_nnz"][r, c] = s.row_nnz

        return cls(op=op, cell_format=cell_format, R=R, C=C,
                   voxel_cuts=plan.voxel_cuts, fiber_cuts=plan.fiber_cuts,
                   nv_local=nv_local, nf_local=nf_local,
                   n_atoms=phi.n_atoms, n_voxels=phi.n_voxels,
                   n_fibers=phi.n_fibers, arrays=out, cell_nnz=cell_nnz,
                   row_tile=row_tile, slot_tile=slot_tile)

    def decode(self) -> PhiTensor:
        """Invert every cell through the inner format and re-globalize
        (host tensors)."""
        parts = {k: [] for k in ("atoms", "voxels", "fibers", "values")}
        for r in range(self.R):
            for c in range(self.C):
                p = self._decode_cell(r, c)
                parts["atoms"].append(to_numpy(p.atoms))
                parts["voxels"].append(to_numpy(p.voxels)
                                       + self.voxel_cuts[r])
                parts["fibers"].append(to_numpy(p.fibers)
                                       + self.fiber_cuts[c])
                parts["values"].append(to_numpy(p.values))

        def cat(k, dtype=None):
            a = np.concatenate(parts[k])
            return torch.from_numpy(a if dtype is None else a.astype(dtype))

        return PhiTensor(
            atoms=cat("atoms", np.int32), voxels=cat("voxels", np.int32),
            fibers=cat("fibers", np.int32), values=cat("values"),
            n_atoms=self.n_atoms, n_voxels=self.n_voxels,
            n_fibers=self.n_fibers)

    def _decode_cell(self, r: int, c: int) -> PhiTensor:
        if self.cell_format == "coo":
            n = int(self.cell_nnz[r, c])
            t = {k: torch.from_numpy(np.ascontiguousarray(
                self.arrays[k][r, c, :n]))
                 for k in ("atoms", "voxels", "fibers", "values")}
            return PhiTensor(**t, n_atoms=self.n_atoms,
                             n_voxels=self.nv_local, n_fibers=self.nf_local)
        cell = SellPhi(
            op=self.op, atoms=self.arrays["atoms"][r, c],
            others=self.arrays["others"][r, c],
            values=self.arrays["values"][r, c],
            row_nnz=self.arrays["row_nnz"][r, c],
            row_tile=self.row_tile, slot_tile=self.slot_tile,
            n_atoms=self.n_atoms, n_voxels=self.nv_local,
            n_fibers=self.nf_local)
        return cell.decode()

    # -- geometry / accounting ------------------------------------------------
    @property
    def plan(self) -> ShardPlan:
        return ShardPlan(R=self.R, C=self.C, voxel_cuts=self.voxel_cuts,
                         fiber_cuts=self.fiber_cuts)

    @property
    def n_coeffs(self) -> int:
        return int(self.cell_nnz.sum())

    @property
    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self.arrays.values())
                   + self.voxel_cuts.nbytes + self.fiber_cuts.nbytes
                   + self.cell_nnz.nbytes)

    @property
    def padding_overhead(self) -> float:
        """Allocated value slots / real coefficients - 1 across all cells."""
        return self.arrays["values"].size / max(1, self.n_coeffs) - 1.0


# ----------------------------------------------------------------------------
# Pure-numpy references over the stacked cell arrays, the reference's: the
# executors' dataflow minus the mesh, the oracle for the distributed path.
# ----------------------------------------------------------------------------

def _cell_operands(shard: ShardPhi, r: int, c: int):
    """(atoms, voxel ids, fiber ids, values) of one cell, flattened and
    cell-local."""
    out_dim = OUTPUT_DIMS[shard.op]
    a = shard.arrays["atoms"][r, c].ravel()
    vals = shard.arrays["values"][r, c].ravel()
    if shard.cell_format == "coo":
        v = shard.arrays["voxels"][r, c].ravel()
        f = shard.arrays["fibers"][r, c].ravel()
    else:
        rows_padded, width = shard.arrays["atoms"].shape[2:]
        rows = np.repeat(np.arange(rows_padded, dtype=np.int64), width)
        others = shard.arrays["others"][r, c].ravel()
        v, f = (rows, others) if out_dim == "voxel" else (others, rows)
    return a, v, f, vals


def dsc_reference(shard: ShardPhi, dictionary, w) -> np.ndarray:
    """y = M w over the stacked cell arrays (padding slots exercised)."""
    d = np.asarray(dictionary)
    w = np.asarray(w)
    y = np.zeros((shard.n_voxels, d.shape[1]), d.dtype)
    for r in range(shard.R):
        for c in range(shard.C):
            a, v, f, vals = _cell_operands(shard, r, c)
            # padding rows may exceed the global range; their values are 0,
            # so clipping the index keeps them inert without branching
            vg = np.minimum(v + shard.voxel_cuts[r], shard.n_voxels - 1)
            fg = np.minimum(f + shard.fiber_cuts[c], shard.n_fibers - 1)
            np.add.at(y, vg, d[a] * (w[fg] * vals)[:, None])
    return y


def wc_reference(shard: ShardPhi, dictionary, y) -> np.ndarray:
    """w = M^T y over the stacked cell arrays."""
    d = np.asarray(dictionary)
    y = np.asarray(y)
    w = np.zeros((shard.n_fibers,), d.dtype)
    for r in range(shard.R):
        for c in range(shard.C):
            a, v, f, vals = _cell_operands(shard, r, c)
            vg = np.minimum(v + shard.voxel_cuts[r], shard.n_voxels - 1)
            fg = np.minimum(f + shard.fiber_cuts[c], shard.n_fibers - 1)
            np.add.at(w, fg, (d[a] * y[vg]).sum(axis=1) * vals)
    return w
