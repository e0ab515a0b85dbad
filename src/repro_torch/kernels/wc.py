"""The WC kernels (w = M^T y): B2 over COO tiles and B4 over SELL, with
their wrappers and plain versions.

``csrc/wc.cu`` (B2) replaces the Pallas TPU kernel
``repro/kernels/wc.py:wc_pallas`` and ``csrc/wc_sell.cu`` (B4) replaces
``repro/kernels/wc.py:wc_sell_pallas``; each source's note says what bounds
it on the card and what its design does about that.  Both gather the Y rows
themselves: unlike the reference, no stream of Y rows is materialized
before the call.  A wrapper launches its kernel on CUDA tensors (counted in
:data:`repro_torch.kernels._build.LAUNCHES`), runs the plain PyTorch
version on CPU tensors, records its op on tensors without data (a trace,
``kernels/dsc.py:traced``) and raises on anything else.  Sums are taken in
float32 whatever the storage type.

B2 operands (built once from a ``TilePlan`` by
:func:`repro_torch.kernels.ops.coo_tiles`):

  tile_ptr     int32[n_fib_blocks + 1]  tile range of each fiber block
  tile_len     int32[n_tiles]           real coefficients at the head of
                                        each tile (the rest is padding)
  atoms_p, voxels_p, local_row_p  int32[n_tiles, c_tile]
  values_p     float32 | bfloat16 [n_tiles, c_tile]
  dictionary   [Na, Ntheta], the same dtype as ``values_p``
  y            float32[Nv, Ntheta]

B2 result: float32[n_fib_blocks * row_tile]; every fiber is written, zeros
for fibers no coefficient reaches.  B2 runs a warp per contiguous range of
fiber blocks, walking their tiles in batches of 32 real slots and summing
each fiber's run by a segmented warp scan, as B6 does over F-COO chunks;
it relies on the same tile layout as B1 (``kernels/dsc.py``).

B4 operands (a fiber-row ``formats/sell.py:SellPhi`` on the device, built
by :func:`repro_torch.kernels.ops.sell_operands`):

  atoms, voxels  int32[rows_padded, width]   slot [r, s]: the s-th
                                             coefficient of fiber r
  values         float32 | bfloat16 [rows_padded, width]
  row_nnz        int32[n_rows]               real slots of each row
  dictionary     [Na, Ntheta], the same dtype as ``values``
  y              float32[Nv, Ntheta]

B4 result: float32[rows_padded]; every row is written, zeros for empty rows
and for the padding rows past ``n_rows``.  B4 runs B2's design over fiber
rows: a warp owns a contiguous range of rows and packs their real slots
(each row's prefix ``[0, row_nnz[r])``) into batches of 32 that span rows
(``csrc/common.cuh:SellWalk``), so short rows leave no lane idle.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dsc import (_check_sell, _d_bytes, _device_of,
                                     sell_slots, traced)
from repro_torch.roofline import spmv_bytes as SB
from repro_torch.roofline import trace_cost as TC

_SIGNATURE = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ENTRY = {torch.float32: "wc_coo_f32", torch.bfloat16: "wc_coo_bf16"}
_SELL_SIGNATURE = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
_SELL_ENTRY = {torch.float32: "wc_sell_f32", torch.bfloat16: "wc_sell_bf16"}


# ----------------------------------------------------------------------------
# B2: COO WC
# ----------------------------------------------------------------------------


def _check(tile_ptr, tile_len, atoms_p, voxels_p, values_p, local_row_p,
           dictionary, y) -> None:
    _build.check_coo_tiles(tile_ptr, tile_len, atoms_p, voxels_p, values_p,
                           local_row_p, dictionary, device=y.device)
    _build.check_operand(y, "y", device=y.device, dtypes=(torch.float32,),
                         shape=(None, dictionary.shape[1]))


def wc_coo_plain(tile_ptr, tile_len, atoms_p, voxels_p, values_p,
                 local_row_p, dictionary, y, *, row_tile: int) -> torch.Tensor:
    """Plain PyTorch version of B2: the same function on the same operands,
    by gather, row dot products and ``index_add_`` over each tile's real
    prefix."""
    n_tiles, c_tile = atoms_p.shape
    n_row_blocks = tile_ptr.numel() - 1
    dev = y.device
    row_block = torch.repeat_interleave(
        torch.arange(n_row_blocks, device=dev), tile_ptr.diff(),
        output_size=n_tiles)
    real = torch.arange(c_tile, device=dev)[None, :] < tile_len[:, None]
    rows = (row_block[:, None] * row_tile + local_row_p)[real]
    dots = (dictionary[atoms_p[real]].float() * y[voxels_p[real]]).sum(dim=1)
    vals = dots * values_p[real].float()
    out = torch.zeros((n_row_blocks * row_tile,), dtype=torch.float32,
                      device=dev)
    return out.index_add_(0, rows, vals)


def wc_coo(tile_ptr, tile_len, atoms_p, voxels_p, values_p, local_row_p,
           dictionary, y, *, row_tile: int) -> torch.Tensor:
    """Run B2 on CUDA tensors; on CPU tensors, the plain version; on
    tensors without data, its traced op (``kernels/dsc.py:traced``).

    Raises:
        ValueError, TypeError: an operand on another device, of another
            dtype or shape, or not contiguous.
        RuntimeError: the CUDA launch was refused.
    """
    _check(tile_ptr, tile_len, atoms_p, voxels_p, values_p, local_row_p,
           dictionary, y)
    n_tiles, c_tile = atoms_p.shape
    n_row_blocks = tile_ptr.numel() - 1
    n_atoms, n_theta = dictionary.shape
    if TC.without_data(y):
        return traced("wc_coo", (n_row_blocks * row_tile,),
                      SB.wc_coo(n_tiles * c_tile, n_theta,
                                n_voxels=y.shape[0],
                                n_row_blocks=n_row_blocks, n_tiles=n_tiles,
                                row_tile=row_tile,
                                d_bytes=_d_bytes(dictionary),
                                value_bytes=values_p.element_size()),
                      y.device)
    dev = _device_of(y, "wc_coo")
    if dev.type == "cpu":
        return wc_coo_plain(tile_ptr, tile_len, atoms_p, voxels_p, values_p,
                            local_row_p, dictionary, y, row_tile=row_tile)
    out = torch.empty((n_row_blocks * row_tile,), dtype=torch.float32,
                      device=dev)
    lib = _build.load("wc", {name: _SIGNATURE for name in _ENTRY.values()})
    _build.launch(lib, _ENTRY[dictionary.dtype], "wc_coo", dev,
                  [tile_ptr, tile_len, atoms_p, voxels_p, values_p,
                   local_row_p, dictionary, y, out],
                  [n_row_blocks, c_tile, row_tile, n_atoms, n_theta])
    return out


# ----------------------------------------------------------------------------
# B4: SELL WC
# ----------------------------------------------------------------------------

def wc_sell_plain(atoms, voxels, values, row_nnz, dictionary,
                  y) -> torch.Tensor:
    """Plain PyTorch version of B4: the same function on the same
    operands, by masked gathers of the real slots, row dot products and
    ``index_add_``."""
    real, rows = sell_slots(atoms, row_nnz)
    dots = (dictionary[atoms[real]].float() * y[voxels[real]]).sum(dim=1)
    out = torch.zeros((atoms.shape[0],), dtype=torch.float32, device=y.device)
    return out.index_add_(0, rows[real], dots * values[real].float())


def wc_sell(atoms, voxels, values, row_nnz, dictionary, y) -> torch.Tensor:
    """Run B4 on CUDA tensors; on CPU tensors, the plain version; on
    tensors without data, its traced op (``kernels/dsc.py:traced``).

    Raises:
        ValueError, TypeError: an operand on another device, of another
            dtype or shape, or not contiguous.
        RuntimeError: the CUDA launch was refused.
    """
    _check_sell(atoms, voxels, values, row_nnz, dictionary, y, row_tile=1,
                x_shape=(None, dictionary.shape[1]))
    rows_padded, width = atoms.shape
    n_atoms, n_theta = dictionary.shape
    if TC.without_data(y):
        return traced("wc_sell", (rows_padded,),
                      SB.wc_sell(rows_padded * width, n_theta,
                                 n_voxels=y.shape[0], n_rows=row_nnz.numel(),
                                 rows_padded=rows_padded,
                                 d_bytes=_d_bytes(dictionary),
                                 value_bytes=values.element_size()),
                      y.device)
    dev = _device_of(y, "wc_sell")
    if dev.type == "cpu":
        return wc_sell_plain(atoms, voxels, values, row_nnz, dictionary, y)
    out = torch.empty((rows_padded,), dtype=torch.float32, device=dev)
    lib = _build.load("wc_sell",
                      {name: _SELL_SIGNATURE for name in _SELL_ENTRY.values()})
    _build.launch(lib, _SELL_ENTRY[dictionary.dtype], "wc_sell", dev,
                  [atoms, voxels, values, row_nnz, dictionary, y, out],
                  [row_nnz.numel(), rows_padded, width, n_atoms, n_theta])
    return out
