"""B2 — COO WC (w = M^T y) over fiber-sorted tiles: wrapper, plain version
and launch count.

The kernel is ``csrc/wc.cu``, hand-written CUDA for Hopper that replaces
the Pallas TPU kernel ``repro/kernels/wc.py:wc_pallas``; its note says what
bounds it on the card and what its design does about that.  It gathers the
Y rows itself: unlike the reference, no ``(n_tiles, c_tile, Ntheta)``
stream of Y rows is materialized before the call.

Operands (built once from a ``TilePlan`` by :func:`repro_torch.kernels.ops.coo_tiles`):

  tile_ptr     int32[n_fib_blocks + 1]  tile range of each fiber block
  tile_len     int32[n_tiles]           real coefficients at the head of
                                        each tile (the rest is padding)
  atoms_p, voxels_p, local_row_p  int32[n_tiles, c_tile]
  values_p     float32 | bfloat16 [n_tiles, c_tile]
  dictionary   [Na, Ntheta], the same dtype as ``values_p``
  y            float32[Nv, Ntheta]

Result: float32[n_fib_blocks * row_tile]; every fiber is written, zeros for
fiber blocks no tile visits.  Sums are taken in float32 whatever the storage
type.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`wc_coo` (the plain version adds nothing)
launches = 0

_SIGNATURE = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ENTRY = {torch.float32: "wc_coo_f32", torch.bfloat16: "wc_coo_bf16"}


def _check(tile_ptr, tile_len, atoms_p, voxels_p, values_p, local_row_p,
           dictionary, y) -> None:
    _build.check_coo_tiles(tile_ptr, tile_len, atoms_p, voxels_p, values_p,
                           local_row_p, dictionary, device=y.device)
    _build.check_operand(y, "y", device=y.device, dtypes=(torch.float32,),
                         shape=(None, dictionary.shape[1]))


def wc_coo_plain(tile_ptr, tile_len, atoms_p, voxels_p, values_p,
                 local_row_p, dictionary, y, *, row_tile: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function on the same
    operands, by gather, row dot products and ``index_add_`` over each
    tile's real prefix."""
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
    """Run B2 on CUDA tensors; on CPU tensors, the plain version.

    Raises:
        ValueError, TypeError: an operand on another device, of another
            dtype or shape, or not contiguous.
        RuntimeError: the CUDA launch was refused.
    """
    global launches
    _check(tile_ptr, tile_len, atoms_p, voxels_p, values_p, local_row_p,
           dictionary, y)
    dev = y.device
    if dev.type == "cpu":
        return wc_coo_plain(tile_ptr, tile_len, atoms_p, voxels_p, values_p,
                            local_row_p, dictionary, y, row_tile=row_tile)
    if dev.type != "cuda":
        raise ValueError(f"wc_coo runs on cuda or cpu tensors, not {dev}")
    n_tiles, c_tile = atoms_p.shape
    n_row_blocks = tile_ptr.numel() - 1
    n_atoms, n_theta = dictionary.shape
    out = torch.empty((n_row_blocks * row_tile,), dtype=torch.float32,
                      device=dev)
    lib = _build.load("wc", {name: _SIGNATURE for name in _ENTRY.values()})
    _build.launch(lib, _ENTRY[dictionary.dtype], "wc_coo", dev,
                  [tile_ptr, tile_len, atoms_p, voxels_p, values_p,
                   local_row_p, dictionary, y, out],
                  [n_row_blocks, c_tile, row_tile, n_atoms, n_theta])
    launches += 1
    return out
