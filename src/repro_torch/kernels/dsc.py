"""The DSC kernels (y = M w): B1 over COO tiles and B3 over SELL, with
their wrappers and plain versions.

``csrc/dsc.cu`` (B1) replaces the Pallas TPU kernel
``repro/kernels/dsc.py:dsc_pallas`` and ``csrc/dsc_sell.cu`` (B3) replaces
``repro/kernels/dsc.py:dsc_sell_pallas``; each source's note says what
bounds it on the card and what its design does about that.  Both fuse the
scaling ``w[fiber] * value`` into the kernel.  A wrapper launches its
kernel on CUDA tensors (counted in :data:`repro_torch.kernels._build.LAUNCHES`),
runs the plain PyTorch version on CPU tensors, records its op on tensors
without data (a trace, :func:`traced`) and raises on anything else.
Sums are taken in float32 whatever the storage type (float32 or bfloat16
dictionary and values).

B1 operands (built once from a ``TilePlan`` by
:func:`repro_torch.kernels.ops.coo_tiles`):

  tile_ptr     int32[n_row_blocks + 1]  tile range of each row block
  tile_len     int32[n_tiles]           real coefficients at the head of
                                        each tile (the rest is padding)
  atoms_p, fibers_p, local_row_p  int32[n_tiles, c_tile]
  values_p     float32 | bfloat16 [n_tiles, c_tile]
  dictionary   [Na, Ntheta], the same dtype as ``values_p``
  w            float32[Nf]

B1 result: float32[n_row_blocks * row_tile, Ntheta]; every row is written
once, zeros for rows no coefficient reaches and for row blocks no tile
visits.  B1 runs a warp per contiguous range of row blocks, walking their
tiles in batches of 32 real slots; it relies on each tile's real slots
being a prefix (``tile_len``) and on ``local_row`` never decreasing within
a row block, across its tiles too, which :func:`ops.coo_tiles` gives for a
plan over sorted ids.

B3 operands (a voxel-row ``formats/sell.py:SellPhi`` on the device, built
by :func:`repro_torch.kernels.ops.sell_operands`):

  atoms, fibers  int32[rows_padded, width]   slot [r, s]: the s-th
                                             coefficient of voxel r
  values         float32 | bfloat16 [rows_padded, width]
  row_nnz        int32[n_rows]               real slots of each row
  dictionary     [Na, Ntheta], the same dtype as ``values``
  w              float32[Nf]

B3 result: float32[rows_padded, Ntheta]; every row is written, zeros for
empty rows and for the padding rows past ``n_rows``.  B3 runs a warp per
row; ``row_tile`` only fixes the padded row count (``rows_padded`` is a
multiple of it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.roofline import spmv_bytes as SB
from repro_torch.roofline import trace_cost as TC

_SIGNATURE = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ENTRY = {torch.float32: "dsc_coo_f32", torch.bfloat16: "dsc_coo_bf16"}
_SELL_SIGNATURE = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
_SELL_ENTRY = {torch.float32: "dsc_sell_f32", torch.bfloat16: "dsc_sell_bf16"}


def _device_of(w: torch.Tensor, name: str) -> torch.device:
    dev = w.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {dev}")
    return dev


def traced(name: str, out_shape: tuple, work: SB.Work, dev,
           scratch: tuple = ()) -> torch.Tensor:
    """A LiFE kernel on tensors without data (a trace,
    ``roofline/trace_cost.py``): its float32 output of ``out_shape`` and
    one op ``name`` of ``work``'s FLOPs and bytes
    (``roofline/spmv_bytes.py`` over the layout's slots, each counted as
    a real coefficient: how many are real is data).  ``scratch``: the
    ``(shape, dtype)`` of the buffers the wrapper allocates beside the
    output on the card, made and dropped as there.  Nothing is built or
    launched."""
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    held = [torch.empty(s, dtype=dt, device=dev) for s, dt in scratch]
    TC.record_kernel(name, work.flops, work.bytes)
    del held                    # freed as the wrapper returns on the card
    return out


def _d_bytes(dictionary: torch.Tensor) -> int:
    return dictionary.numel() * dictionary.element_size()


# ----------------------------------------------------------------------------
# B1: COO DSC
# ----------------------------------------------------------------------------

def _check(tile_ptr, tile_len, atoms_p, fibers_p, values_p, local_row_p,
           dictionary, w) -> None:
    _build.check_coo_tiles(tile_ptr, tile_len, atoms_p, fibers_p, values_p,
                           local_row_p, dictionary, device=w.device)
    _build.check_operand(w, "w", device=w.device, dtypes=(torch.float32,),
                         shape=(None,))


def dsc_coo_plain(tile_ptr, tile_len, atoms_p, fibers_p, values_p,
                  local_row_p, dictionary, w, *, row_tile: int) -> torch.Tensor:
    """Plain PyTorch version of B1: the same function on the same
    operands, by gather and ``index_add_`` over each tile's real prefix."""
    n_tiles, c_tile = atoms_p.shape
    n_row_blocks = tile_ptr.numel() - 1
    dev = w.device
    row_block = torch.repeat_interleave(
        torch.arange(n_row_blocks, device=dev), tile_ptr.diff(),
        output_size=n_tiles)
    real = torch.arange(c_tile, device=dev)[None, :] < tile_len[:, None]
    rows = (row_block[:, None] * row_tile + local_row_p)[real]
    scaled = w[fibers_p[real]] * values_p[real].float()
    contrib = dictionary[atoms_p[real]].float() * scaled[:, None]
    out = torch.zeros((n_row_blocks * row_tile, dictionary.shape[1]),
                      dtype=torch.float32, device=dev)
    return out.index_add_(0, rows, contrib)


def dsc_coo(tile_ptr, tile_len, atoms_p, fibers_p, values_p, local_row_p,
            dictionary, w, *, row_tile: int) -> torch.Tensor:
    """Run B1 on CUDA tensors; on CPU tensors, the plain version; on
    tensors without data, its traced op (:func:`traced`).

    Raises:
        ValueError, TypeError: an operand on another device, of another
            dtype or shape, or not contiguous.
        RuntimeError: the CUDA launch was refused.
    """
    _check(tile_ptr, tile_len, atoms_p, fibers_p, values_p, local_row_p,
           dictionary, w)
    n_tiles, c_tile = atoms_p.shape
    n_row_blocks = tile_ptr.numel() - 1
    n_atoms, n_theta = dictionary.shape
    if TC.without_data(w):
        return traced("dsc_coo", (n_row_blocks * row_tile, n_theta),
                      SB.dsc_coo(n_tiles * c_tile, n_theta,
                                 n_fibers=w.numel(),
                                 n_row_blocks=n_row_blocks, n_tiles=n_tiles,
                                 row_tile=row_tile,
                                 d_bytes=_d_bytes(dictionary),
                                 value_bytes=values_p.element_size()),
                      w.device)
    dev = _device_of(w, "dsc_coo")
    if dev.type == "cpu":
        return dsc_coo_plain(tile_ptr, tile_len, atoms_p, fibers_p, values_p,
                             local_row_p, dictionary, w, row_tile=row_tile)
    out = torch.empty((n_row_blocks * row_tile, n_theta),
                      dtype=torch.float32, device=dev)
    lib = _build.load("dsc", {name: _SIGNATURE for name in _ENTRY.values()})
    _build.launch(lib, _ENTRY[dictionary.dtype], "dsc_coo", dev,
                  [tile_ptr, tile_len, atoms_p, fibers_p, values_p,
                   local_row_p, dictionary, w, out],
                  [n_row_blocks, c_tile, row_tile, n_atoms, n_theta])
    return out


# ----------------------------------------------------------------------------
# B3: SELL DSC
# ----------------------------------------------------------------------------

def _check_sell(atoms, others, values, row_nnz, dictionary, x, *,
                row_tile: int, x_shape: tuple) -> None:
    """The checks of :func:`_build.check_operand` over the SELL operands
    shared by B3 and B4 (``x`` is ``w`` for B3 and ``Y`` for B4)."""
    dev = x.device
    rows_padded, width = atoms.shape
    i32 = (torch.int32,)
    _build.check_operand(atoms, "atoms", device=dev, dtypes=i32,
                         shape=(None, None))
    _build.check_operand(others, "others", device=dev, dtypes=i32,
                         shape=(rows_padded, width))
    _build.check_operand(dictionary, "dictionary", device=dev,
                         dtypes=(torch.float32, torch.bfloat16),
                         shape=(None, None))
    _build.check_operand(values, "values", device=dev,
                         dtypes=(dictionary.dtype,), shape=(rows_padded, width))
    _build.check_operand(row_nnz, "row_nnz", device=dev, dtypes=i32,
                         shape=(None,))
    _build.check_operand(x, "w" if len(x_shape) == 1 else "y", device=dev,
                         dtypes=(torch.float32,), shape=x_shape)
    if row_tile < 1 or rows_padded % row_tile:
        raise ValueError(f"{rows_padded} SELL rows are not a multiple of "
                         f"row_tile={row_tile}")
    if row_nnz.numel() > rows_padded:
        raise ValueError(f"row_nnz has {row_nnz.numel()} rows, the layout "
                         f"{rows_padded}")


def sell_slots(atoms: torch.Tensor, row_nnz: torch.Tensor):
    """(mask of the real slots, row of every slot) of a SELL layout: the
    first ``row_nnz[r]`` slots of row ``r`` are real; padding rows past
    ``row_nnz``'s length hold none."""
    rows_padded, width = atoms.shape
    dev = atoms.device
    nnz = torch.zeros(rows_padded, dtype=torch.int64, device=dev)
    nnz[:row_nnz.numel()] = row_nnz
    real = torch.arange(width, device=dev)[None, :] < nnz[:, None]
    rows = torch.arange(rows_padded, device=dev)[:, None].expand(-1, width)
    return real, rows


def dsc_sell_plain(atoms, fibers, values, row_nnz, dictionary, w, *,
                   row_tile: int) -> torch.Tensor:
    """Plain PyTorch version of B3: the same function on the same
    operands, by masked gathers of the real slots and ``index_add_``."""
    real, rows = sell_slots(atoms, row_nnz)
    scaled = w[fibers[real]] * values[real].float()
    contrib = dictionary[atoms[real]].float() * scaled[:, None]
    out = torch.zeros((atoms.shape[0], dictionary.shape[1]),
                      dtype=torch.float32, device=w.device)
    return out.index_add_(0, rows[real], contrib)


def dsc_sell(atoms, fibers, values, row_nnz, dictionary, w, *,
             row_tile: int) -> torch.Tensor:
    """Run B3 on CUDA tensors; on CPU tensors, the plain version; on
    tensors without data, its traced op (:func:`traced`).

    Raises:
        ValueError, TypeError: an operand on another device, of another
            dtype or shape, or not contiguous.
        RuntimeError: the CUDA launch was refused.
    """
    _check_sell(atoms, fibers, values, row_nnz, dictionary, w,
                row_tile=row_tile, x_shape=(None,))
    rows_padded, width = atoms.shape
    n_atoms, n_theta = dictionary.shape
    if TC.without_data(w):
        return traced("dsc_sell", (rows_padded, n_theta),
                      SB.dsc_sell(rows_padded * width, n_theta,
                                  n_fibers=w.numel(), n_rows=row_nnz.numel(),
                                  rows_padded=rows_padded,
                                  d_bytes=_d_bytes(dictionary),
                                  value_bytes=values.element_size()),
                      w.device)
    dev = _device_of(w, "dsc_sell")
    if dev.type == "cpu":
        return dsc_sell_plain(atoms, fibers, values, row_nnz, dictionary, w,
                              row_tile=row_tile)
    out = torch.empty((rows_padded, n_theta), dtype=torch.float32, device=dev)
    lib = _build.load("dsc_sell",
                      {name: _SELL_SIGNATURE for name in _SELL_ENTRY.values()})
    _build.launch(lib, _SELL_ENTRY[dictionary.dtype], "dsc_sell", dev,
                  [atoms, fibers, values, row_nnz, dictionary, w, out],
                  [row_nnz.numel(), rows_padded, width, n_atoms, n_theta])
    return out
