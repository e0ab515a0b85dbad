"""Bind inspector TilePlans to the COO kernels (torch counterpart of
``repro/kernels/ops.py:make_dsc`` / ``make_wc``).

:func:`coo_tiles` turns a ``TilePlan`` into the kernels' device operands
once — padded ``(n_tiles, c_tile)`` tiles, each tile's real length, and a
CSR-style ``tile_ptr`` giving every row block its contiguous tile range —
and ``make_dsc`` / ``make_wc`` return closures whose only dynamic input is
``w`` / ``Y``, so the host-side planning is amortized over the solver's
iterations.

Three things of the reference do not carry over: the 128-lane padding of
Ntheta, the ``_visited_mask`` (the kernels write every output row, zeros
included), and the XLA pre-gather of Y rows for WC (the WC kernel gathers
them itself).

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
