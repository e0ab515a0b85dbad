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
gather them themselves), and the per-call regather of the F-COO stream's
atoms and values through ``wc_perm`` (B6 reads through ``wc_perm`` itself,
so the stream stays one resident copy).

Compute dtype (DESIGN.md §10.3): ``compute_dtype="bf16"`` stores the static
operands — the dictionary and the Phi values — in bfloat16, while every
sum is taken in float32; ``w`` and ``Y`` stay float32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

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
    """

    atoms: torch.Tensor           # int32[n_chunks, c_tile]
    voxels: torch.Tensor          # int32[n_chunks, c_tile]
    fibers: torch.Tensor          # int32[n_chunks, c_tile]
    values: torch.Tensor          # storage dtype [n_chunks, c_tile]
    wc_perm: torch.Tensor         # int32[n_chunks, c_tile]
    dsc_ranks: torch.Tensor       # int32[n_chunks, c_tile]
    wc_ranks: torch.Tensor        # int32[n_chunks, c_tile]
    seg_rows_dsc: torch.Tensor    # int64[n_chunks * k_dsc]
    seg_rows_wc: torch.Tensor     # int64[n_chunks * k_wc]
    k_dsc: int
    k_wc: int
    n_voxels: int
    n_fibers: int

    @property
    def n_chunks(self) -> int:
        return self.atoms.shape[0]


def fcoo_operands(fc, device, *, compute_dtype: str = "fp32"
                  ) -> FcooOperands:
    """Upload ``fc`` to ``device`` once; values in their storage dtype."""
    shape = (fc.n_chunks, fc.c_tile)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return FcooOperands(
        atoms=t(fc.atoms).reshape(shape), voxels=t(fc.voxels).reshape(shape),
        fibers=t(fc.fibers).reshape(shape),
        values=storage_cast(t(fc.values), compute_dtype).reshape(shape),
        wc_perm=t(fc.wc_perm).reshape(shape),
        dsc_ranks=t(fc.dsc_ranks).reshape(shape),
        wc_ranks=t(fc.wc_ranks).reshape(shape),
        seg_rows_dsc=t(fc.seg_rows_dsc, torch.int64).reshape(-1),
        seg_rows_wc=t(fc.seg_rows_wc, torch.int64).reshape(-1),
        k_dsc=fc.k_dsc, k_wc=fc.k_wc, n_voxels=fc.n_voxels,
        n_fibers=fc.n_fibers)


def fcoo_dsc_partials(o: FcooOperands, d: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """B5 over ``o``: (n_chunks, k_dsc, Ntheta) segment partials."""
    return fcoo_kernel.dsc_fcoo(o.atoms, o.fibers, o.values, o.dsc_ranks, d,
                                w, seg_k=o.k_dsc)


def fcoo_wc_partials(o: FcooOperands, d: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """B6 over ``o``: (n_chunks, k_wc) segment partials."""
    return fcoo_kernel.wc_fcoo(o.wc_perm, o.atoms.reshape(-1),
                               o.voxels.reshape(-1), o.values.reshape(-1),
                               o.wc_ranks, d, y, seg_k=o.k_wc)


def fcoo_combine(parts: torch.Tensor, seg_rows: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """Fold segment partials onto their output rows: one ``index_add_``
    over ``seg_rows`` (a run split across chunks lands twice on its row;
    padding segments land on the dummy row ``n_rows``, trimmed here)."""
    rows = parts.new_zeros((n_rows + 1,) + parts.shape[2:])
    rows.index_add_(0, seg_rows, parts.reshape((-1,) + parts.shape[2:]))
    return rows[:n_rows]


def make_fcoo_ops(fc, dictionary: torch.Tensor, *,
                  compute_dtype: str = "fp32"):
    """(matvec, rmatvec) over ONE resident ``formats/fcoo.py:FcooPhi``,
    running kernels B5 and B6 (their plain versions on CPU tensors) and
    the ``seg_rows`` combine.  An empty Phi launches nothing and gives
    zeros."""
    dev = dictionary.device
    n_theta = dictionary.shape[1]
    if fc.n_chunks == 0:
        return (lambda w: torch.zeros((fc.n_voxels, n_theta),
                                      dtype=torch.float32, device=dev),
                lambda y: torch.zeros((fc.n_fibers,), dtype=torch.float32,
                                      device=dev))
    o = fcoo_operands(fc, dev, compute_dtype=compute_dtype)
    d = storage_cast(dictionary, compute_dtype).contiguous()

    def matvec(w: torch.Tensor) -> torch.Tensor:
        return fcoo_combine(fcoo_dsc_partials(o, d, w), o.seg_rows_dsc,
                            o.n_voxels)

    def rmatvec(y: torch.Tensor) -> torch.Tensor:
        return fcoo_combine(fcoo_wc_partials(o, d, y), o.seg_rows_wc,
                            o.n_fibers)

    return matvec, rmatvec
