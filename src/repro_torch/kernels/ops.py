"""Bind plans and layouts to the kernels (torch counterpart of
``repro/kernels/ops.py``).

:func:`coo_tiles` turns a ``TilePlan`` into the COO kernels' device
operands once — padded ``(n_tiles, c_tile)`` tiles, each tile's real
length, and a CSR-style ``tile_ptr`` giving every row block its contiguous
tile range — and ``make_dsc`` / ``make_wc`` return closures whose only
dynamic input is ``w`` / ``Y``, so the host-side planning is amortized over
the solver's iterations.  :func:`sell_operands` and :func:`fcoo_operands`
upload a SELL or F-COO layout once, and ``make_dsc_sell`` /
``make_wc_sell`` / ``make_fcoo_ops`` bind kernels B3–B6 to them the same
way.

Four things of the reference do not carry over: the 128-lane padding of
Ntheta, the ``_visited_mask`` (the kernels write every output row, zeros
included), the XLA pre-gathers of Y rows for the WC kernels (B2, B4 and B6
gather them themselves), the per-call regather of the F-COO stream's atoms
and values through ``wc_perm`` (B6 reads through ``wc_perm`` itself, so the
stream stays one resident copy), and the scatter-adds that fold the F-COO
kernels' partials: B5 and B6 fold runs that cross chunks themselves, in a
fixed order.  :func:`fcoo_combine` folds the Pallas kernels' partials only
for the yardsticks :func:`fcoo_dsc_folded` and :func:`fcoo_wc_folded`.

Compute dtype (DESIGN.md §10.3): ``compute_dtype="bf16"`` stores the static
operands — the dictionary and the Phi values — in bfloat16, while every
sum is taken in float32; ``w`` and ``Y`` stay float32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.inspector import TilePlan
from repro_torch.core.std import PhiTensor
from repro_torch.kernels import dsc as dsc_kernel
from repro_torch.kernels import fcoo as fcoo_kernel
from repro_torch.kernels import wc as wc_kernel


def storage_cast(x: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """Cast a *static* operand to its storage dtype ("bf16" halves resident
    bytes; anything else is identity).  Never used on accumulators."""
    if compute_dtype == "bf16":
        return x.to(torch.bfloat16)
    return x


@dataclasses.dataclass(frozen=True)
class CooTiles:
    """Device operands of one COO kernel, built once from a TilePlan.

    ``others_p`` holds the input-side index of each slot: fibers for DSC,
    voxels for WC.  Padding slots hold index 0 and value 0.
    """

    tile_ptr: torch.Tensor        # int32[n_row_blocks + 1]
    tile_len: torch.Tensor        # int32[n_tiles]
    atoms_p: torch.Tensor         # int32[n_tiles, c_tile]
    others_p: torch.Tensor        # int32[n_tiles, c_tile]
    values_p: torch.Tensor        # storage dtype [n_tiles, c_tile]
    local_row_p: torch.Tensor     # int32[n_tiles, c_tile]
    row_tile: int
    n_rows: int                   # unpadded output rows

    @property
    def n_row_blocks(self) -> int:
        return self.tile_ptr.numel() - 1


def coo_tiles(phi_sorted: PhiTensor, plan: TilePlan, others: torch.Tensor,
              n_rows: int, *, compute_dtype: str = "fp32") -> CooTiles:
    """Kernel operands for ``plan`` over ``phi_sorted`` on phi's device.

    ``others`` is phi's input-side index vector (``phi_sorted.fibers`` for
    DSC, ``phi_sorted.voxels`` for WC) and ``n_rows`` the output size.

    Raises:
        ValueError: the plan's row blocks are not in order (it was not made
            over sorted ids) or it does not match ``phi_sorted``.
    """
    if plan.n_coeffs != phi_sorted.n_coeffs:
        raise ValueError(f"plan covers {plan.n_coeffs} coefficients, "
                         f"phi holds {phi_sorted.n_coeffs}")
    row_block = np.asarray(plan.row_block, np.int64)
    if np.any(np.diff(row_block) < 0):
        raise ValueError("tile plan row blocks must be nondecreasing "
                         "(plan over sorted ids)")
    dev = phi_sorted.device
    n_tiles, c_tile = plan.n_tiles, plan.c_tile
    n_row_blocks = plan.n_rows_padded // plan.row_tile
    # plan_tiles fills each tile from its head: the real coefficients are a
    # prefix, the padding (sel == Nc) a suffix
    sel_2d = np.asarray(plan.sel).reshape(n_tiles, c_tile)
    tile_len = (sel_2d < plan.n_coeffs).sum(axis=1)
    tile_ptr = np.searchsorted(row_block, np.arange(n_row_blocks + 1))
    sel = torch.as_tensor(plan.sel, device=dev).long()

    def padded(a: torch.Tensor) -> torch.Tensor:
        return torch.cat([a, a.new_zeros(1)])[sel].reshape(n_tiles, c_tile)

    def i32(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)

    return CooTiles(
        tile_ptr=i32(tile_ptr), tile_len=i32(tile_len),
        atoms_p=padded(phi_sorted.atoms).int(),
        others_p=padded(others).int(),
        values_p=storage_cast(padded(phi_sorted.values), compute_dtype),
        local_row_p=i32(np.asarray(plan.local_row).reshape(n_tiles, c_tile)),
        row_tile=plan.row_tile, n_rows=n_rows)


def make_dsc(phi_voxel_sorted: PhiTensor, dictionary: torch.Tensor,
             plan: TilePlan, *, compute_dtype: str = "fp32") -> Callable:
    """matvec(w) -> (Nv, Ntheta) running kernel B1 (its plain version on
    CPU tensors)."""
    t = coo_tiles(phi_voxel_sorted, plan, phi_voxel_sorted.fibers,
                  phi_voxel_sorted.n_voxels, compute_dtype=compute_dtype)
    d = storage_cast(dictionary, compute_dtype).contiguous()

    def matvec(w: torch.Tensor) -> torch.Tensor:
        y = dsc_kernel.dsc_coo(t.tile_ptr, t.tile_len, t.atoms_p, t.others_p,
                               t.values_p, t.local_row_p, d, w,
                               row_tile=t.row_tile)
        return y[:t.n_rows]

    return matvec


def make_wc(phi_fiber_sorted: PhiTensor, dictionary: torch.Tensor,
            plan: TilePlan, *, compute_dtype: str = "fp32") -> Callable:
    """rmatvec(Y) -> (Nf,) running kernel B2 (its plain version on CPU
    tensors)."""
    t = coo_tiles(phi_fiber_sorted, plan, phi_fiber_sorted.voxels,
                  phi_fiber_sorted.n_fibers, compute_dtype=compute_dtype)
    d = storage_cast(dictionary, compute_dtype).contiguous()

    def rmatvec(y: torch.Tensor) -> torch.Tensor:
        w = wc_kernel.wc_coo(t.tile_ptr, t.tile_len, t.atoms_p, t.others_p,
                             t.values_p, t.local_row_p, d, y,
                             row_tile=t.row_tile)
        return w[:t.n_rows]

    return rmatvec


# ----------------------------------------------------------------------------
# SELL (kernels B3 / B4)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SellOperands:
    """One ``formats/sell.py:SellPhi`` on the device (B3/B4 operands)."""

    atoms: torch.Tensor           # int32[rows_padded, width]
    others: torch.Tensor          # int32[rows_padded, width]
    values: torch.Tensor          # storage dtype [rows_padded, width]
    row_nnz: torch.Tensor         # int32[n_rows]
    row_tile: int
    n_rows: int


def sell_operands(sell, device, *, compute_dtype: str = "fp32"
                  ) -> SellOperands:
    """Upload ``sell``'s slot arrays to ``device`` once; values in their
    storage dtype."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return SellOperands(
        atoms=t(sell.atoms), others=t(sell.others),
        values=storage_cast(t(sell.values), compute_dtype),
        row_nnz=t(sell.row_nnz), row_tile=sell.row_tile, n_rows=sell.n_rows)


def make_dsc_sell(sell, dictionary: torch.Tensor, *,
                  compute_dtype: str = "fp32") -> Callable:
    """matvec(w) -> (Nv, Ntheta) running kernel B3 over a voxel-row
    ``SellPhi`` (its plain version on CPU tensors).  The layout's slot
    arrays are the whole plan: no TilePlan, no row map."""
    if sell.op != "dsc":
        raise ValueError(f"need a dsc-layout SellPhi, got op={sell.op!r}")
    o = sell_operands(sell, dictionary.device, compute_dtype=compute_dtype)
    d = storage_cast(dictionary, compute_dtype).contiguous()

    def matvec(w: torch.Tensor) -> torch.Tensor:
        y = dsc_kernel.dsc_sell(o.atoms, o.others, o.values, o.row_nnz, d, w,
                                row_tile=o.row_tile)
        return y[:o.n_rows]

    return matvec


def make_wc_sell(sell, dictionary: torch.Tensor, *,
                 compute_dtype: str = "fp32") -> Callable:
    """rmatvec(Y) -> (Nf,) running kernel B4 over a fiber-row ``SellPhi``
    (its plain version on CPU tensors)."""
    if sell.op != "wc":
        raise ValueError(f"need a wc-layout SellPhi, got op={sell.op!r}")
    o = sell_operands(sell, dictionary.device, compute_dtype=compute_dtype)
    d = storage_cast(dictionary, compute_dtype).contiguous()

    def rmatvec(y: torch.Tensor) -> torch.Tensor:
        w = wc_kernel.wc_sell(o.atoms, o.others, o.values, o.row_nnz, d, y)
        return w[:o.n_rows]

    return rmatvec


# ----------------------------------------------------------------------------
# F-COO (kernels B5 / B6)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FcooOperands:
    """One ``formats/fcoo.py:FcooPhi`` on the device (B5/B6 operands).

    The stream arrays are one resident copy: B5 reads them as
    ``(n_chunks, c_tile)`` views, B6 reads them flat through ``wc_perm``.
    B5 and B6 find their segments from the voxels and from ``wc_fibers``
    (``fibers[wc_perm]``, the fiber-major view's fibers), so the ranks and
    segment maps of both ops stay on the host.
    """

    atoms: torch.Tensor           # int32[n_chunks, c_tile]
    voxels: torch.Tensor          # int32[n_chunks, c_tile]
    fibers: torch.Tensor          # int32[n_chunks, c_tile]
    values: torch.Tensor          # storage dtype [n_chunks, c_tile]
    wc_perm: torch.Tensor         # int32[n_chunks, c_tile]
    wc_fibers: torch.Tensor       # int32[n_chunks, c_tile]
    n_voxels: int
    n_fibers: int

    @property
    def n_chunks(self) -> int:
        return self.atoms.shape[0]

    @property
    def nbytes(self) -> int:
        """Bytes the card holds for the layout (``FcooPhi.nbytes`` counts
        the host encoding's nine arrays, as the reference does)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.atoms, self.voxels, self.fibers,
                             self.values, self.wc_perm, self.wc_fibers))


def fcoo_operands(fc, device, *, compute_dtype: str = "fp32"
                  ) -> FcooOperands:
    """Upload ``fc`` to ``device`` once; values in their storage dtype."""
    shape = (fc.n_chunks, fc.c_tile)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a),
                               device=device).reshape(shape)

    return FcooOperands(
        atoms=t(fc.atoms), voxels=t(fc.voxels), fibers=t(fc.fibers),
        values=storage_cast(t(fc.values), compute_dtype),
        wc_perm=t(fc.wc_perm), wc_fibers=t(fc.fibers[fc.wc_perm]),
        n_voxels=fc.n_voxels, n_fibers=fc.n_fibers)


def fcoo_dsc(o: FcooOperands, d: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """B5 over ``o``: y = M w, (n_voxels, Ntheta)."""
    return fcoo_kernel.dsc_fcoo(o.atoms, o.fibers, o.values, o.voxels, d, w,
                                n_voxels=o.n_voxels)


def fcoo_wc(o: FcooOperands, d: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """B6 over ``o``: w = Mᵀ y, (n_fibers,)."""
    return fcoo_kernel.wc_fcoo(o.wc_perm, o.wc_fibers, o.atoms.reshape(-1),
                               o.voxels.reshape(-1), o.values.reshape(-1), d,
                               y, n_fibers=o.n_fibers)


def _host_ranks(ranks, o: FcooOperands, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(ranks),
                           device=device).reshape(o.atoms.shape)


def _host_seg_rows(seg_rows, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(seg_rows), dtype=torch.int64,
                           device=device).reshape(-1)


def fcoo_dsc_partials(fc, o: FcooOperands, d: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """The Pallas kernel's (n_chunks, k_dsc, Ntheta) segment partials over
    ``o``, in plain PyTorch, with the ranks of ``fc`` (the host encoding
    ``o`` was made from): a yardstick, since B5 writes y itself."""
    return fcoo_kernel.dsc_fcoo_plain(
        o.atoms, o.fibers, o.values, _host_ranks(fc.dsc_ranks, o, d.device),
        d, w, seg_k=fc.k_dsc)


def fcoo_dsc_folded(fc, o: FcooOperands, d: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """y = M w the reference's way: :func:`fcoo_dsc_partials` folded over
    ``fc.seg_rows_dsc`` by :func:`fcoo_combine` (a yardstick for B5)."""
    return fcoo_combine(fcoo_dsc_partials(fc, o, d, w),
                        _host_seg_rows(fc.seg_rows_dsc, d.device),
                        fc.n_voxels)


def fcoo_wc_partials(fc, o: FcooOperands, d: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """The Pallas kernel's (n_chunks, k_wc) segment partials over ``o``, in
    plain PyTorch, with the ranks of ``fc``: a yardstick, since B6 writes
    w itself."""
    return fcoo_kernel.wc_fcoo_plain(
        o.wc_perm, o.atoms.reshape(-1), o.voxels.reshape(-1),
        o.values.reshape(-1), _host_ranks(fc.wc_ranks, o, d.device), d, y,
        seg_k=fc.k_wc)


def fcoo_wc_folded(fc, o: FcooOperands, d: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """w = Mᵀ y the reference's way: :func:`fcoo_wc_partials` folded over
    ``fc.seg_rows_wc`` by :func:`fcoo_combine` (a yardstick for B6)."""
    return fcoo_combine(fcoo_wc_partials(fc, o, d, y),
                        _host_seg_rows(fc.seg_rows_wc, d.device),
                        fc.n_fibers)


def fcoo_combine(parts: torch.Tensor, seg_rows: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """Fold segment partials onto their output rows: one ``index_add_``
    over ``seg_rows`` (a run split across chunks lands twice on its row;
    padding segments land on the dummy row ``n_rows``, trimmed here)."""
    rows = parts.new_zeros((n_rows + 1,) + parts.shape[2:])
    rows.index_add_(0, seg_rows, parts.reshape((-1,) + parts.shape[2:]))
    return rows[:n_rows]


def make_fcoo_ops(fc, dictionary: torch.Tensor, *,
                  compute_dtype: str = "fp32",
                  operands: Optional[FcooOperands] = None):
    """(matvec, rmatvec) over ONE resident ``formats/fcoo.py:FcooPhi``,
    running kernels B5 and B6, one launch each, which fold their chunks
    themselves (their plain versions on CPU tensors).  ``operands`` are
    ``fc`` already uploaded by the caller, which then reads their bytes;
    by default they are uploaded here.  An empty Phi launches nothing and
    gives zeros."""
    dev = dictionary.device
    n_theta = dictionary.shape[1]
    if fc.n_chunks == 0:
        return (lambda w: torch.zeros((fc.n_voxels, n_theta),
                                      dtype=torch.float32, device=dev),
                lambda y: torch.zeros((fc.n_fibers,), dtype=torch.float32,
                                      device=dev))
    o = operands if operands is not None else fcoo_operands(
        fc, dev, compute_dtype=compute_dtype)
    d = storage_cast(dictionary, compute_dtype).contiguous()

    def matvec(w: torch.Tensor) -> torch.Tensor:
        return fcoo_dsc(o, d, w)

    def rmatvec(y: torch.Tensor) -> torch.Tensor:
        return fcoo_wc(o, d, y)

    return matvec, rmatvec
