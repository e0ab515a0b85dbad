"""SELL: sliced-ELL/blocked Phi layout for direct row-block accumulation.

Torch counterpart of ``repro/formats/sell.py``.  Coefficients are sorted by
the op's output dimension (voxel for DSC, fiber for WC) and laid out row
major: slot ``[r, s]`` holds the ``s``-th coefficient of output row ``r``.
Every row is padded to the common ``width`` (a ``slot_tile`` multiple) with
inert slots (index 0, value 0), and rows are padded to a ``row_tile``
multiple, so a row block's slots sit at a fixed place and the kernels need
no row map (kernels B3/B4, ``kernels/dsc_sell.py``/``wc_sell.py``).

The price is padding: ``width`` is the longest row rounded up, so skewed
row degrees waste slots.  :mod:`repro_torch.formats.select` weighs that
with :func:`repro_torch.core.inspector.phi_stats`.  The CUDA kernels read
only each row's ``row_nnz`` real slots, so on the card the padding costs
memory, not bandwidth.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from repro_torch import obs
from repro_torch.bridge import to_numpy
from repro_torch.core.inspector import sell_geometry
from repro_torch.core.std import PhiTensor
from repro_torch.formats.base import OUTPUT_DIMS, register_format

DEFAULT_ROW_TILE = 8         # output rows per block
DEFAULT_SLOT_TILE = 32       # width is a multiple of this


def _dims_for(op: str):
    """(output dim, other dim) index-vector names for an op."""
    out = OUTPUT_DIMS[op]
    return out, ("fiber" if out == "voxel" else "voxel")


@register_format
@dataclasses.dataclass
class SellPhi:
    """Blocked-ELL Phi for one op, dense ``(n_rows_padded, width)`` arrays.

    ``atoms``/``others``/``values``: slot ``[r, s]`` is the ``s``-th
    coefficient of output row ``r`` (``others`` holds fibers for DSC,
    voxels for WC; padding slots hold index 0 and value 0).  ``row_nnz`` is
    the exact per-row coefficient count.  ``device`` is where the input lay
    and where ``decode`` puts its result.
    """

    name: ClassVar[str] = "sell"

    op: str                              # "dsc" | "wc"
    atoms: np.ndarray                    # int32 (n_rows_padded, width)
    others: np.ndarray                   # int32 (n_rows_padded, width)
    values: np.ndarray                   # fp    (n_rows_padded, width)
    row_nnz: np.ndarray                  # int32 (n_rows,)
    row_tile: int
    slot_tile: int
    n_atoms: int
    n_voxels: int
    n_fibers: int
    device: str = "cpu"

    # -- encode / decode ------------------------------------------------------
    @classmethod
    def encode(cls, phi: PhiTensor, *, op: str = "dsc",
               row_tile: int = DEFAULT_ROW_TILE,
               slot_tile: int = DEFAULT_SLOT_TILE, **_params) -> "SellPhi":
        """Lay one op's coefficients out row by row: a ``build.encode``
        span, whose argsort (with the take that applies it) is a
        ``build.sort`` span."""
        with obs.span("build.encode", {"format": cls.name, "op": op,
                                       "n_coeffs": phi.n_coeffs}):
            out_dim, other_dim = _dims_for(op)
            vec = {"atom": phi.atoms, "voxel": phi.voxels,
                   "fiber": phi.fibers}
            out_ids = to_numpy(vec[out_dim]).astype(np.int64)
            n_rows = {"voxel": phi.n_voxels, "fiber": phi.n_fibers}[out_dim]
            nc = out_ids.size

            with obs.span("build.sort", {"dim": out_dim, "n_coeffs": nc}):
                order = np.argsort(out_ids, kind="stable")
                out_sorted = out_ids[order]
            row_nnz = np.bincount(out_sorted,
                                  minlength=n_rows).astype(np.int32)
            max_nnz = int(row_nnz.max()) if nc else 0
            width, n_rows_padded = sell_geometry(max_nnz, n_rows,
                                                 row_tile=row_tile,
                                                 slot_tile=slot_tile)

            atoms = np.zeros((n_rows_padded, width), np.int32)
            others = np.zeros((n_rows_padded, width), np.int32)
            np_vals = to_numpy(phi.values)
            values = np.zeros((n_rows_padded, width), np_vals.dtype)
            if nc:
                row_start = np.zeros(n_rows + 1, np.int64)
                np.cumsum(row_nnz, out=row_start[1:])
                slot = np.arange(nc) - row_start[out_sorted]  # pos in row
                flat = out_sorted * width + slot
                atoms.reshape(-1)[flat] = to_numpy(phi.atoms).astype(
                    np.int32)[order]
                others.reshape(-1)[flat] = to_numpy(vec[other_dim]).astype(
                    np.int32)[order]
                values.reshape(-1)[flat] = np_vals[order]
            return cls(op=op, atoms=atoms, others=others, values=values,
                       row_nnz=row_nnz, row_tile=row_tile,
                       slot_tile=slot_tile, n_atoms=phi.n_atoms,
                       n_voxels=phi.n_voxels, n_fibers=phi.n_fibers,
                       device=str(phi.device))

    def decode(self) -> PhiTensor:
        out_dim, _ = _dims_for(self.op)
        width = self.atoms.shape[1]
        mask = (np.arange(width)[None, :]
                < self.row_nnz[:, None].astype(np.int64))      # (n_rows, W)
        rows = np.broadcast_to(
            np.arange(self.n_rows)[:, None], mask.shape)[mask]
        trimmed = slice(0, self.n_rows)
        atoms = self.atoms[trimmed][mask]
        others = self.others[trimmed][mask]
        values = self.values[trimmed][mask]
        out32 = rows.astype(np.int32)
        voxels, fibers = ((out32, others) if out_dim == "voxel"
                          else (others, out32))

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

        return PhiTensor(atoms=t(atoms), voxels=t(voxels), fibers=t(fibers),
                         values=t(values), n_atoms=self.n_atoms,
                         n_voxels=self.n_voxels, n_fibers=self.n_fibers)

    # -- geometry / accounting ------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.n_voxels if self.op == "dsc" else self.n_fibers

    @property
    def n_coeffs(self) -> int:
        return int(self.row_nnz.sum())

    @property
    def width(self) -> int:
        return self.atoms.shape[1]

    @property
    def n_row_blocks(self) -> int:
        return self.atoms.shape[0] // self.row_tile

    @property
    def n_chunks(self) -> int:
        return self.width // self.slot_tile

    @property
    def slice_widths(self) -> np.ndarray:
        """Per row-block width a ragged SELL-C-sigma would allocate
        (max row nnz in the slice, rounded up to the slot tile)."""
        padded = np.zeros(self.atoms.shape[0], np.int64)
        padded[: self.n_rows] = self.row_nnz
        per_slice = padded.reshape(-1, self.row_tile).max(axis=1)
        return -(-per_slice // self.slot_tile) * self.slot_tile

    @property
    def nbytes(self) -> int:
        return int(self.atoms.nbytes + self.others.nbytes + self.values.nbytes
                   + self.row_nnz.nbytes)

    @property
    def padding_overhead(self) -> float:
        """Allocated slots / real coefficients - 1 over the dense layout."""
        slots = self.atoms.size
        return slots / max(1, self.n_coeffs) - 1.0


# ----------------------------------------------------------------------------
# Plain torch executors over the SELL layout, the reference's jnp ones
# (per-row slot reduction, no scatter) on the dictionary's device: oracles
# of the layout's semantics.  The executor runs kernels B3/B4 instead.
# ----------------------------------------------------------------------------

def dsc_reference(sell: SellPhi, dictionary: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """y = M w over the SELL layout: per-row slot reduction, no scatter."""
    dev = dictionary.device
    atoms = torch.as_tensor(sell.atoms, device=dev).long()
    fibers = torch.as_tensor(sell.others, device=dev).long()
    values = torch.as_tensor(sell.values, device=dev)
    scaled = w[fibers] * values                    # (rows_padded, W)
    contrib = dictionary[atoms] * scaled[..., None]
    return contrib.sum(dim=1)[: sell.n_voxels]     # (Nv, Ntheta)


def wc_reference(sell: SellPhi, dictionary: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """w = M^T y over the SELL layout: per-row dot accumulation."""
    dev = dictionary.device
    atoms = torch.as_tensor(sell.atoms, device=dev).long()
    voxels = torch.as_tensor(sell.others, device=dev).long()
    values = torch.as_tensor(sell.values, device=dev)
    dots = (dictionary[atoms] * y[voxels]).sum(-1) * values
    return dots.sum(dim=1)[: sell.n_fibers]        # (Nf,)
