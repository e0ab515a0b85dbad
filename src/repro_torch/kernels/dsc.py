"""B1 — COO DSC (y = M w) over voxel-sorted tiles: wrapper, plain version
and launch count.

The kernel is ``csrc/dsc.cu``, hand-written CUDA for Hopper that replaces
the Pallas TPU kernel ``repro/kernels/dsc.py:dsc_pallas``; its note says
what bounds it on the card and what its design does about that.  The
scaling ``w[fiber] * value`` is fused into it.

Operands (built once from a ``TilePlan`` by :func:`repro_torch.kernels.ops.coo_tiles`):

  tile_ptr     int32[n_row_blocks + 1]  tile range of each row block
  tile_len     int32[n_tiles]           real coefficients at the head of
                                        each tile (the rest is padding)
  atoms_p, fibers_p, local_row_p  int32[n_tiles, c_tile]
  values_p     float32 | bfloat16 [n_tiles, c_tile]
  dictionary   [Na, Ntheta], the same dtype as ``values_p``
  w            float32[Nf]

Result: float32[n_row_blocks * row_tile, Ntheta]; every row is written,
zeros for row blocks no tile visits.  Sums are taken in float32 whatever the
storage type.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`dsc_coo` (the plain version adds nothing)
launches = 0

_SIGNATURE = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ENTRY = {torch.float32: "dsc_coo_f32", torch.bfloat16: "dsc_coo_bf16"}


def _check(tile_ptr, tile_len, atoms_p, fibers_p, values_p, local_row_p,
           dictionary, w) -> None:
    _build.check_coo_tiles(tile_ptr, tile_len, atoms_p, fibers_p, values_p,
                           local_row_p, dictionary, device=w.device)
    _build.check_operand(w, "w", device=w.device, dtypes=(torch.float32,),
                         shape=(None,))


def dsc_coo_plain(tile_ptr, tile_len, atoms_p, fibers_p, values_p,
                  local_row_p, dictionary, w, *, row_tile: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function on the same
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
    """Run B1 on CUDA tensors; on CPU tensors, the plain version.

    Raises:
        ValueError, TypeError: an operand on another device, of another
            dtype or shape, or not contiguous.
        RuntimeError: the CUDA launch was refused.
    """
    global launches
    _check(tile_ptr, tile_len, atoms_p, fibers_p, values_p, local_row_p,
           dictionary, w)
    dev = w.device
    if dev.type == "cpu":
        return dsc_coo_plain(tile_ptr, tile_len, atoms_p, fibers_p, values_p,
                             local_row_p, dictionary, w, row_tile=row_tile)
    if dev.type != "cuda":
        raise ValueError(f"dsc_coo runs on cuda or cpu tensors, not {dev}")
    n_tiles, c_tile = atoms_p.shape
    n_row_blocks = tile_ptr.numel() - 1
    n_atoms, n_theta = dictionary.shape
    out = torch.empty((n_row_blocks * row_tile, n_theta),
                      dtype=torch.float32, device=dev)
    lib = _build.load("dsc", {name: _SIGNATURE for name in _ENTRY.values()})
    _build.launch(lib, _ENTRY[dictionary.dtype], "dsc_coo", dev,
                  [tile_ptr, tile_len, atoms_p, fibers_p, values_p,
                   local_row_p, dictionary, w, out],
                  [n_row_blocks, c_tile, row_tile, n_atoms, n_theta])
    launches += 1
    return out
