"""Distributed LiFE: 2-D (voxel x fiber) mesh partition of SBBNNLS.

Torch counterpart of ``repro/distributed/life_shard.py``: the paper's
computation partitioning (§4.1.3) lifted from threads to a mesh of cells
(its MPI-LiFE comparison point, §7.1.3):

  * voxel ranges go to the mesh rows (axis ``data``), R row groups,
  * fiber ranges go to the mesh columns (axis ``model``), C column groups,
  * each cell owns the Phi coefficients of its (voxel-range x fiber-range)
    block TWICE (voxel-sorted for DSC, fiber-sorted for WC: the per-op
    restructuring), with *localized* indices,
  * DSC: a local sorted segment sum, then ``psum`` over ``model``,
  * WC : a local sorted segment sum, then ``psum`` over ``data``,
  * the SBBNNLS dots: a local dot, then ``psum`` over the axis the operand
    is split on (w-like: ``model``; y-like: ``data``).

Boundaries are equal-nnz and snapped to sub-vector boundaries
(``formats/shard.py:partition_cuts``); padding coefficients carry value 0
and are inert through both ops and the solver.

The reference runs these under ``shard_map``.  Here each function runs the
cells a :mod:`~repro_torch.distributed.mesh` mesh holds: every cell of a
:class:`~repro_torch.distributed.mesh.LocalMesh` in one process (the
registry's ``shard`` / ``shard-sell`` executors), or one cell per rank of a
:class:`~repro_torch.distributed.mesh.ProcessGroupMesh`.  So operands are
dicts: cell operands keyed by ``(r, c)``, y-like vectors (``b``, ``Y``,
each ``(nv_local, Ntheta)``) by row ``r``, w-like ones (``(nf_local,)``)
by column ``c``.  :func:`sharded_state` builds them for the cells a mesh
holds, each on its cell's device.

:func:`make_sharded_ops` runs the segment sums in plain tensor ops (the
``opt`` executor's ``core/spmv.py``), as the reference runs jnp ops there.
:func:`make_sharded_sell_ops` runs kernels B3 and B4 once per cell
(``kernels/dsc.py:dsc_sell``, ``kernels/wc.py:wc_sell``) on the cell's
slice ``[r, c]`` of the stacked slot arrays and its ``row_nnz``, each
uploaded once as a contiguous tensor: B3 gathers ``w`` and B4
gathers the Y rows themselves, so the reference's pre-scaled operand and
its pre-gather of Y rows have no counterpart.  The iteration's odd/even
branch is taken on the host-side ``it``, as in ``core/sbbnnls.py``.

:func:`life_input_specs` and :func:`life_input_specs_1d` give the dry
run's operands at paper scale as ``meta`` tensors (no allocation), the
reference's shapes for a mesh whose rows are its batch axes (``pod`` and
``data``) and whose columns are ``model``; :func:`rank0_operands` cuts
them to the cell one device holds, the steps' operands without data
(their ``lengths`` too: ``bincount`` cannot run on ``meta``), and
:func:`without_data` turns operands that hold data into such copies.  The
dry run traces the steps over them (``launch/dryrun.py:trace_life``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import spmv
from repro_torch.core.sbbnnls import _dot, _safe_div, projected_gradient
from repro_torch.core.std import PhiTensor
from repro_torch.kernels.ops import SellOperands, storage_cast

Cell = Tuple[int, int]


@dataclasses.dataclass
class LifeShards:
    """Host-side 2-D partition (R x C cells, padded to common sizes)."""
    # each (R, C, nnz_max) int32/float32; *_local indices are cell-relative
    dsc_atoms: np.ndarray
    dsc_voxels_local: np.ndarray
    dsc_fibers_local: np.ndarray
    dsc_values: np.ndarray
    wc_atoms: np.ndarray
    wc_voxels_local: np.ndarray
    wc_fibers_local: np.ndarray
    wc_values: np.ndarray
    nv_local: int
    nf_local: int
    n_theta: int
    R: int
    C: int
    voxel_cuts: np.ndarray      # (R+1,) global voxel boundaries
    fiber_cuts: np.ndarray      # (C+1,)

    @property
    def meta(self) -> Dict[str, int]:
        return dict(nv_local=self.nv_local, nf_local=self.nf_local,
                    n_theta=self.n_theta)


def build_life_shards(phi: PhiTensor, n_theta: int, R: int, C: int,
                      cache=None) -> LifeShards:
    """The 2-D partition through the format subsystem: both per-op layouts
    are :class:`~repro_torch.formats.shard.ShardPhi` encodes over inner COO
    cells sharing one :func:`~repro_torch.formats.shard.partition_cuts`
    plan (persistent-cache-backed when ``cache`` is given)."""
    from repro_torch.formats.shard import encode_pair, partition_cuts

    plan = partition_cuts(phi, R, C, cell_format="coo", cache=cache)
    dsc, wc = encode_pair(phi, cell_format="coo", plan=plan)
    return LifeShards(
        dsc_atoms=dsc.arrays["atoms"], dsc_voxels_local=dsc.arrays["voxels"],
        dsc_fibers_local=dsc.arrays["fibers"], dsc_values=dsc.arrays["values"],
        wc_atoms=wc.arrays["atoms"], wc_voxels_local=wc.arrays["voxels"],
        wc_fibers_local=wc.arrays["fibers"], wc_values=wc.arrays["values"],
        nv_local=plan.nv_local, nf_local=plan.nf_local, n_theta=n_theta,
        R=R, C=C, voxel_cuts=plan.voxel_cuts, fiber_cuts=plan.fiber_cuts)


def shard_b(shards: LifeShards, b: np.ndarray) -> np.ndarray:
    """(Nv, Ntheta) -> (R * nv_local, Ntheta) row-padded layout."""
    out = np.zeros((shards.R * shards.nv_local, b.shape[1]), b.dtype)
    for r in range(shards.R):
        lo, hi = shards.voxel_cuts[r], shards.voxel_cuts[r + 1]
        out[r * shards.nv_local: r * shards.nv_local + (hi - lo)] = b[lo:hi]
    return out


def shard_w(shards: LifeShards, w: np.ndarray) -> np.ndarray:
    """(Nf,) -> (C * nf_local,) column-padded layout."""
    out = np.zeros((shards.C * shards.nf_local,), w.dtype)
    for c in range(shards.C):
        lo, hi = shards.fiber_cuts[c], shards.fiber_cuts[c + 1]
        out[c * shards.nf_local: c * shards.nf_local + (hi - lo)] = w[lo:hi]
    return out


def unshard_w(shards: LifeShards, w_padded: np.ndarray) -> np.ndarray:
    """(C * nf_local,) column-padded layout -> (Nf,)."""
    segs = []
    for c in range(shards.C):
        lo, hi = shards.fiber_cuts[c], shards.fiber_cuts[c + 1]
        segs.append(w_padded[c * shards.nf_local:
                             c * shards.nf_local + (hi - lo)])
    return np.concatenate(segs)


# ----------------------------------------------------------------------------
# cell operands
# ----------------------------------------------------------------------------

class CooCell(NamedTuple):
    """One cell's sorted COO operands of one op on its device: the cell's
    PhiTensor (localized ids), the run lengths of its output ids (the
    segment sums' inspector work, done once) and the dictionary."""
    phi: PhiTensor
    lengths: torch.Tensor
    d: torch.Tensor


class SellCell(NamedTuple):
    """One cell's SELL operands of one op on its device (its slice
    ``[r, c]`` of the stacked slot arrays) and the dictionary."""
    o: SellOperands
    d: torch.Tensor


def cell_arrays(arrays: Dict[str, np.ndarray],
                cells) -> Dict[Cell, Dict[str, np.ndarray]]:
    """Each cell's views ``arrays[k][r, c]`` of stacked ``(R, C, ...)``
    arrays (a ShardPhi's or LifeShards'), for the given cells."""
    return {(r, c): {k: a[r, c] for k, a in arrays.items()}
            for r, c in cells}


def _upload(a: np.ndarray, dev) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


def coo_cells(mesh, cells: Dict[Cell, Dict[str, np.ndarray]], op: str, *,
              n_atoms: int, nv_local: int, nf_local: int,
              dictionary: torch.Tensor,
              compute_dtype: str = "fp32") -> Dict[Cell, CooCell]:
    """Sorted COO cells for ``op`` ("dsc": voxel-sorted, "wc":
    fiber-sorted) on their devices, from each cell's host ``atoms`` /
    ``voxels`` / ``fibers`` / ``values`` (:func:`cell_arrays` of a coo
    ShardPhi)."""
    out = {}
    for (r, c), arrs in cells.items():
        dev = mesh.device_of(r, c)
        t = {k: _upload(arrs[k], dev)
             for k in ("atoms", "voxels", "fibers", "values")}
        phi = PhiTensor(atoms=t["atoms"], voxels=t["voxels"],
                        fibers=t["fibers"],
                        values=storage_cast(t["values"], compute_dtype),
                        n_atoms=n_atoms, n_voxels=nv_local,
                        n_fibers=nf_local)
        ids, n = ((phi.voxels, nv_local) if op == "dsc"
                  else (phi.fibers, nf_local))
        out[(r, c)] = CooCell(
            phi, spmv.segment_lengths(ids, n),
            storage_cast(dictionary.to(dev), compute_dtype).contiguous())
    return out


def sell_cells(mesh, cells: Dict[Cell, Dict[str, np.ndarray]], *,
               row_tile: int, dictionary: torch.Tensor,
               compute_dtype: str = "fp32") -> Dict[Cell, SellCell]:
    """SELL cells on their devices, from each cell's host ``atoms`` /
    ``others`` / ``values`` ``(rows_padded, width)`` and ``row_nnz``
    (:func:`cell_arrays` of a sell ShardPhi)."""
    out = {}
    for (r, c), arrs in cells.items():
        dev = mesh.device_of(r, c)
        o = SellOperands(
            atoms=_upload(arrs["atoms"], dev),
            others=_upload(arrs["others"], dev),
            values=storage_cast(_upload(arrs["values"], dev), compute_dtype),
            row_nnz=_upload(arrs["row_nnz"], dev), row_tile=row_tile,
            n_rows=arrs["row_nnz"].shape[-1])
        out[(r, c)] = SellCell(
            o, storage_cast(dictionary.to(dev), compute_dtype).contiguous())
    return out


# ----------------------------------------------------------------------------
# SpMVs over the cells
# ----------------------------------------------------------------------------

def make_sharded_ops(mesh, shards_meta: Dict[str, int]):
    """The per-op SpMVs of the ``shard`` path over sorted COO cells.

    Returns ``(dsc_fn, wc_fn)``:
      dsc_fn(cells, w) -> {r: (nv_local, Ntheta)}, w = {c: (nf_local,)}
      wc_fn(cells, y)  -> {c: (nf_local,)},        y = {r: (nv_local, Ntheta)}
    over the :func:`coo_cells` of each op.
    """
    def dsc_fn(cells: Dict[Cell, CooCell], w: Dict[int, torch.Tensor]):
        parts = {(r, c): spmv.dsc(cell.phi, cell.d,
                                  w[c].to(cell.phi.device), cell.lengths)
                 for (r, c), cell in cells.items()}
        return mesh.psum(parts, "model")

    def wc_fn(cells: Dict[Cell, CooCell], y: Dict[int, torch.Tensor]):
        parts = {(r, c): spmv.wc(cell.phi, cell.d,
                                 y[r].to(cell.phi.device), cell.lengths)
                 for (r, c), cell in cells.items()}
        return mesh.psum(parts, "data")

    return dsc_fn, wc_fn


def make_sharded_sell_ops(mesh, shards_meta: Dict[str, int]):
    """The per-op SpMVs of the ``shard-sell`` path: kernels B3 (DSC) and
    B4 (WC) once per cell, then the ``psum``.  On CPU tensors the wrappers
    run their plain versions.

    Returns ``(dsc_fn, wc_fn)`` with :func:`make_sharded_ops`' signatures,
    over the :func:`sell_cells` of each op.
    """
    from repro_torch.kernels import dsc as dsc_kernel
    from repro_torch.kernels import wc as wc_kernel

    nv_l = shards_meta["nv_local"]
    nf_l = shards_meta["nf_local"]

    def dsc_fn(cells: Dict[Cell, SellCell], w: Dict[int, torch.Tensor]):
        parts = {}
        for (r, c), (o, d) in cells.items():
            y = dsc_kernel.dsc_sell(o.atoms, o.others, o.values, o.row_nnz,
                                    d, w[c].to(d.device).contiguous(),
                                    row_tile=o.row_tile)
            parts[(r, c)] = y[:nv_l]
        return mesh.psum(parts, "model")

    def wc_fn(cells: Dict[Cell, SellCell], y: Dict[int, torch.Tensor]):
        parts = {}
        for (r, c), (o, d) in cells.items():
            w = wc_kernel.wc_sell(o.atoms, o.others, o.values, o.row_nnz, d,
                                  y[r].to(d.device).contiguous())
            parts[(r, c)] = w[:nf_l]
        return mesh.psum(parts, "data")

    return dsc_fn, wc_fn


# ----------------------------------------------------------------------------
# SBBNNLS over the cells
# ----------------------------------------------------------------------------

def _dot_y(mesh, x: Dict[int, torch.Tensor], z: Dict[int, torch.Tensor]):
    """<x, z> of two y-like (row-split) vectors: a local dot per row, then
    ``psum`` over ``data``."""
    local = {r: _dot(x[r], z[r]) for r in x}
    out = mesh.psum({(r, c): local[r] for r, c in mesh.cells}, "data")
    return next(iter(out.values()))


def _dot_w(mesh, x: Dict[int, torch.Tensor], z: Dict[int, torch.Tensor]):
    """<x, z> of two w-like (column-split) vectors: a local dot per
    column, then ``psum`` over ``model``."""
    local = {c: _dot(x[c], z[c]) for c in x}
    out = mesh.psum({(r, c): local[c] for r, c in mesh.cells}, "model")
    return next(iter(out.values()))


def make_sharded_step(mesh, shards_meta: Dict[str, int]):
    """The distributed SBBNNLS iteration over a mesh's cells.

    ``step(dsc_cells, wc_cells, b, w, it) -> (w_new, loss)``: ``b`` maps
    each held row ``r`` to its ``(nv_local, Ntheta)`` block, ``w`` each
    held column ``c`` to its ``(nf_local,)`` block; ``it`` is the host
    iteration counter (odd: one WC, even: two).  ``w_new`` has ``w``'s
    keys; ``loss`` is ``0.5 ||M w - b||^2`` (0-d).  The cells are
    :func:`coo_cells` of each op (or :func:`sharded_state`'s).
    """
    dsc, wc = make_sharded_ops(mesh, shards_meta)

    def step(dsc_cells, wc_cells, b, w, it: int):
        y = {r: yr - b[r] for r, yr in dsc(dsc_cells, w).items()}   # DSC
        g = wc(wc_cells, y)                                         # WC
        gt = {c: projected_gradient(w[c], g[c]) for c in w}
        v = dsc(dsc_cells, gt)                                      # DSC
        if it % 2 == 1:
            alpha = _safe_div(_dot_w(mesh, gt, gt), _dot_y(mesh, v, v))
        else:
            vv = {c: projected_gradient(w[c], x)                    # WC
                  for c, x in wc(wc_cells, v).items()}
            alpha = _safe_div(_dot_y(mesh, v, v), _dot_w(mesh, vv, vv))
        w_new = {c: torch.clamp_min(w[c] - alpha * gt[c], 0.0) for c in w}
        return w_new, 0.5 * _dot_y(mesh, y, y)

    return step


# ----------------------------------------------------------------------------
# the 1-D coefficient partition (MPI-LiFE, §7.1.3)
# ----------------------------------------------------------------------------

def build_life_shards_1d(phi: PhiTensor, n_dev: int) -> Dict[str, np.ndarray]:
    """The 1-D partition :func:`make_sharded_step_1d` runs over: the
    voxel-sorted coefficients cut into ``n_dev`` blocks of
    ``ceil(Nc / n_dev)``, stacked ``(n_dev, nnz_cell)``.  The padded tail
    holds value 0 at the last voxel, so each block stays voxel-sorted.
    (The reference builds these blocks only as dry-run shapes,
    ``life_input_specs_1d``.)"""
    from repro_torch.bridge import to_numpy
    a, v, f, vals = (to_numpy(t) for t in
                     (phi.atoms, phi.voxels, phi.fibers, phi.values))
    order = np.argsort(v, kind="stable")
    nnz_cell = max(1, -(-v.size // n_dev))
    out = dict(atoms=np.zeros(n_dev * nnz_cell, np.int32),
               voxels=np.full(n_dev * nnz_cell, max(0, phi.n_voxels - 1),
                              np.int32),
               fibers=np.zeros(n_dev * nnz_cell, np.int32),
               values=np.zeros(n_dev * nnz_cell, vals.dtype))
    for k, src in (("atoms", a), ("voxels", v), ("fibers", f),
                   ("values", vals)):
        out[k][:v.size] = src[order]
    return {k: x.reshape(n_dev, nnz_cell) for k, x in out.items()}


def make_sharded_step_1d(mesh, shards_meta: Dict[str, int]):
    """The paper's 1-D coefficient partitioning (the MPI-LiFE analogue,
    §7.1.3): every cell owns a coefficient block; Y and w are REPLICATED
    and every SpMV ends in a ``psum`` over the whole mesh, so its
    collective volume is the full Y and w instead of the per-cell outputs.

    ``step(cells, b, w, it) -> (w_new, loss)``: ``cells`` are the blocks
    of :func:`build_life_shards_1d` a mesh holds (block ``r * C + c`` on
    cell ``(r, c)``) as :func:`coo_cells` of op "dsc" with global sizes
    (``nv_local=Nv``, ``nf_local=Nf``); ``b`` ``(Nv, Ntheta)`` and ``w``
    ``(Nf,)`` are whole.
    """
    def dsc(cells, w):
        parts = {rc: spmv.dsc(cell.phi, cell.d, w, cell.lengths)
                 for rc, cell in cells.items()}
        return mesh.psum(parts, ("data", "model"))[()]     # full-Y reduction

    def wc(cells, y):
        parts = {rc: spmv.wc_naive(cell.phi, cell.d, y)
                 for rc, cell in cells.items()}
        return mesh.psum(parts, ("data", "model"))[()]     # full-w reduction

    def step(cells, b, w, it: int):
        y = dsc(cells, w) - b
        g = wc(cells, y)
        gt = projected_gradient(w, g)
        vv1 = dsc(cells, gt)
        if it % 2 == 1:
            alpha = _safe_div(_dot(gt, gt), _dot(vv1, vv1))
        else:
            vv2 = projected_gradient(w, wc(cells, vv1))
            alpha = _safe_div(_dot(vv1, vv1), _dot(vv2, vv2))
        return (torch.clamp_min(w - alpha * gt, 0.0),
                0.5 * _dot(y, y))

    return step


# ----------------------------------------------------------------------------
# placement
# ----------------------------------------------------------------------------

def sharded_state(mesh, shards: LifeShards, problem,
                  w0: Optional[np.ndarray] = None) -> dict:
    """The operands of the cells ``mesh`` holds, each on its cell's
    device (the counterpart of ``device_put`` under ``NamedSharding``):
    ``dsc`` and ``wc`` cells, ``b`` by row and ``w`` by column, ready for
    :func:`make_sharded_step`."""
    from repro_torch.bridge import to_numpy
    d = problem.dictionary
    kw = dict(n_atoms=problem.phi.n_atoms, nv_local=shards.nv_local,
              nf_local=shards.nf_local, dictionary=d)
    b_pad = shard_b(shards, to_numpy(problem.b))
    w_pad = shard_w(shards, w0 if w0 is not None else
                    np.ones(problem.phi.n_fibers, np.float32))
    nv_l, nf_l = shards.nv_local, shards.nf_local
    b, w = {}, {}
    for r, c in mesh.cells:
        dev = mesh.device_of(r, c)
        b.setdefault(r, torch.as_tensor(b_pad[r * nv_l:(r + 1) * nv_l],
                                        device=dev))
        w.setdefault(c, torch.as_tensor(w_pad[c * nf_l:(c + 1) * nf_l],
                                        device=dev))
    return dict(
        dsc=coo_cells(mesh, cell_arrays(op_arrays(shards, "dsc"),
                                        mesh.cells), "dsc", **kw),
        wc=coo_cells(mesh, cell_arrays(op_arrays(shards, "wc"),
                                       mesh.cells), "wc", **kw),
        b=b, w=w)


def op_arrays(shards: LifeShards, op: str) -> Dict[str, np.ndarray]:
    """One op's stacked cell arrays of ``shards`` under ShardPhi's names
    (``atoms``, ``voxels``, ``fibers``, ``values``)."""
    return {k: getattr(shards, f"{op}_{k}" if k in ("atoms", "values")
                       else f"{op}_{k}_local")
            for k in ("atoms", "voxels", "fibers", "values")}


# ----------------------------------------------------------------------------
# dry-run shapes (meta tensors; no allocation)
# ----------------------------------------------------------------------------

def _row_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the voxel rows span: ``pod`` and ``data``, where the
    mesh has them."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def life_input_specs_1d(mesh, *, n_voxels: int = 247_356,
                        n_fibers: int = 500_000, n_theta: int = 96,
                        n_atoms: int = 1_024, nnz: int = 400_000_000
                        ) -> Dict[str, object]:
    """:func:`make_sharded_step_1d`'s operands at paper scale as ``meta``
    tensors: ``(n_dev, ceil(nnz / n_dev))`` coefficient blocks, the whole
    ``b`` and ``w``, and ``meta`` (the global sizes)."""
    n_dev = int(mesh.size)
    nnz_cell = -(-nnz // n_dev)
    i32, f32 = torch.int32, torch.float32
    return dict(
        a=_meta((n_dev, nnz_cell), i32), v=_meta((n_dev, nnz_cell), i32),
        fi=_meta((n_dev, nnz_cell), i32), vals=_meta((n_dev, nnz_cell), f32),
        d=_meta((n_atoms, n_theta), f32), b=_meta((n_voxels, n_theta), f32),
        w=_meta((n_fibers,), f32), it=_meta((), i32),
        meta=dict(n_voxels=n_voxels, n_fibers=n_fibers, n_theta=n_theta),
    )


def life_input_specs(mesh, *, n_voxels: int = 247_356,
                     n_fibers: int = 500_000, n_theta: int = 96,
                     n_atoms: int = 1_024, nnz: int = 400_000_000
                     ) -> Dict[str, object]:
    """:func:`make_sharded_step`'s operands at paper scale (Table 9,
    iFOD1/500k: 2.5e5 voxels, 5e5 fibers, 4e8 coefficients) as ``meta``
    tensors for a mesh of R rows (its ``pod`` x ``data``) and C columns
    (``model``): each op's four ``(R, C, ceil(nnz / RC))`` cell arrays
    (``da dv df dw`` for DSC, ``wa wv wf ww`` for WC), the dictionary,
    ``b`` ``(R * nv_local, Ntheta)``, ``w`` ``(C * nf_local,)``, ``it``, and
    ``meta`` (``nv_local``, ``nf_local``, ``n_theta``)."""
    R = int(np.prod([mesh.shape[a] for a in _row_axes(mesh)]))
    C = int(mesh.shape["model"])
    nv_l = -(-n_voxels // R)
    nf_l = -(-n_fibers // C)
    nnz_cell = -(-nnz // (R * C))
    i32, f32 = torch.int32, torch.float32
    cells = {k: _meta((R, C, nnz_cell), f32 if k.endswith("w") else i32)
             for k in ("da", "dv", "df", "dw", "wa", "wv", "wf", "ww")}
    return dict(
        **cells,
        d=_meta((n_atoms, n_theta), f32),
        b=_meta((R * nv_l, n_theta), f32),
        w=_meta((C * nf_l,), f32),
        it=_meta((), i32),
        meta=dict(nv_local=nv_l, nf_local=nf_l, n_theta=n_theta),
    )


def rank0_operands(specs: Dict[str, object], variant: str = "2d") -> dict:
    """The operands rank 0 holds, cut from :func:`life_input_specs`'
    (``variant`` "2d") or :func:`life_input_specs_1d`'s ("1d") ``meta``
    tensors: cell ``(0, 0)``'s :class:`CooCell` of each op (its
    ``lengths`` a ``meta`` int64 tensor of one entry per output id), and
    ``b`` and ``w`` as :func:`make_sharded_step` takes them (row 0's and
    column 0's blocks, keyed 0) or :func:`make_sharded_step_1d` (whole),
    under :func:`sharded_state`'s keys (``cells`` for the 1-D step's)."""
    d, b, w = specs["d"], specs["b"], specs["w"]

    def cell(keys, n_voxels, n_fibers, op):
        a, v, f, vals = (specs[k].reshape(-1, specs[k].shape[-1])[0]
                         for k in keys)
        phi = PhiTensor(atoms=a, voxels=v, fibers=f, values=vals,
                        n_atoms=d.shape[0], n_voxels=n_voxels,
                        n_fibers=n_fibers)
        n = n_voxels if op == "dsc" else n_fibers
        return {(0, 0): CooCell(phi, _meta((n,), torch.int64), d)}

    if variant == "1d":
        nv, nf = b.shape[0], w.shape[0]
        return dict(cells=cell(("a", "v", "fi", "vals"), nv, nf, "dsc"),
                    b=b, w=w)
    meta = specs["meta"]
    nv_l, nf_l = meta["nv_local"], meta["nf_local"]
    return dict(dsc=cell(("da", "dv", "df", "dw"), nv_l, nf_l, "dsc"),
                wc=cell(("wa", "wv", "wf", "ww"), nv_l, nf_l, "wc"),
                b={0: b[:nv_l]}, w={0: w[:nf_l]})


def without_data(x):
    """``x`` (a tensor, a :class:`CooCell`, a PhiTensor, or a dict of
    them) with every tensor replaced by a ``meta`` tensor of its shape and
    dtype: the operands of a step a trace runs."""
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if isinstance(x, dict):
        return {k: without_data(v) for k, v in x.items()}
    if isinstance(x, PhiTensor):
        return dataclasses.replace(x, **{
            k: without_data(getattr(x, k))
            for k in ("atoms", "voxels", "fibers", "values")})
    if isinstance(x, CooCell):
        return CooCell(*map(without_data, x))
    return x
