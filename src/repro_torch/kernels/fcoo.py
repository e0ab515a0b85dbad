"""The F-COO kernels B5 (DSC) and B6 (WC): wrappers and plain versions.

``csrc/dsc_fcoo.cu`` (B5) replaces the Pallas TPU kernel
``repro/kernels/fcoo.py:dsc_fcoo_pallas`` and ``csrc/wc_fcoo.cu`` (B6)
replaces ``repro/kernels/fcoo.py:wc_fcoo_pallas``; each source's note says
what bounds it on the card and what its design does about that.  Both write
per-chunk segment partials, zeros past a chunk's last segment, exactly the
reference kernels' outputs; :func:`repro_torch.kernels.ops.make_fcoo_ops`
folds them over ``seg_rows_*`` with one ``index_add_``.  A wrapper launches
its kernel on CUDA tensors (counted in
:data:`repro_torch.kernels._build.LAUNCHES`), runs the plain PyTorch
version on CPU tensors, and raises on anything else.  Sums are taken in
float32 whatever the storage type.

Operands (one ``formats/fcoo.py:FcooPhi`` on the device, built by
:func:`repro_torch.kernels.ops.fcoo_operands`):

  B5: atoms, fibers, ranks  int32[n_chunks, c_tile]  the voxel-major stream
                                                     and its DSC ranks
      values    float32 | bfloat16 [n_chunks, c_tile]
      w         float32[Nf]
      result    float32[n_chunks, seg_k, Ntheta]
  B6: wc_perm, ranks        int32[n_chunks, c_tile]  the fiber-major view
                                                     and its WC ranks
      atoms, voxels  int32[Ncp]        the stream itself, read through
      values    float32 | bfloat16 [Ncp]   wc_perm inside the kernel
      y         float32[Nv, Ntheta]
      result    float32[n_chunks, seg_k]

``dictionary`` is [Na, Ntheta] in the values' dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dsc import _device_of

_DSC_SIGNATURE = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p])
_DSC_ENTRY = {torch.float32: "dsc_fcoo_f32", torch.bfloat16: "dsc_fcoo_bf16"}
_WC_SIGNATURE = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])
_WC_ENTRY = {torch.float32: "wc_fcoo_f32", torch.bfloat16: "wc_fcoo_bf16"}


def _check_dictionary(dictionary, dev) -> None:
    _build.check_operand(dictionary, "dictionary", device=dev,
                         dtypes=(torch.float32, torch.bfloat16),
                         shape=(None, None))


def _check_seg_k(seg_k: int, c_tile: int) -> None:
    if not 1 <= seg_k <= max(1, c_tile):
        raise ValueError(f"seg_k={seg_k} must lie in 1..c_tile={c_tile}")


def _slot_segments(ranks: torch.Tensor, seg_k: int) -> torch.Tensor:
    """Row of every slot in the flattened (n_chunks * seg_k) partials."""
    n_chunks = ranks.shape[0]
    base = torch.arange(n_chunks, device=ranks.device)[:, None] * seg_k
    return (base + ranks).reshape(-1)


# ----------------------------------------------------------------------------
# B5: F-COO DSC
# ----------------------------------------------------------------------------

def dsc_fcoo_plain(atoms, fibers, values, ranks, dictionary, w, *,
                   seg_k: int) -> torch.Tensor:
    """Plain PyTorch version of B5: gathers and one ``index_add_`` of every
    slot's contribution onto its (chunk, rank) partial."""
    n_chunks, _ = atoms.shape
    n_theta = dictionary.shape[1]
    scaled = w[fibers] * values.float()
    contrib = dictionary[atoms].float() * scaled[..., None]
    out = torch.zeros((n_chunks * seg_k, n_theta), dtype=torch.float32,
                      device=w.device)
    out.index_add_(0, _slot_segments(ranks, seg_k),
                   contrib.reshape(-1, n_theta))
    return out.reshape(n_chunks, seg_k, n_theta)


def dsc_fcoo(atoms, fibers, values, ranks, dictionary, w, *,
             seg_k: int) -> torch.Tensor:
    """Run B5 on CUDA tensors; on CPU tensors, the plain version.

    Raises:
        ValueError, TypeError: an operand on another device, of another
            dtype or shape, or not contiguous.
        RuntimeError: the CUDA launch was refused.
    """
    dev = w.device
    n_chunks, c_tile = atoms.shape
    for name, t in (("atoms", atoms), ("fibers", fibers), ("ranks", ranks)):
        _build.check_operand(t, name, device=dev, dtypes=(torch.int32,),
                             shape=(n_chunks, c_tile))
    _check_dictionary(dictionary, dev)
    _build.check_operand(values, "values", device=dev,
                         dtypes=(dictionary.dtype,), shape=(n_chunks, c_tile))
    _build.check_operand(w, "w", device=dev, dtypes=(torch.float32,),
                         shape=(None,))
    _check_seg_k(seg_k, c_tile)
    dev = _device_of(w, "dsc_fcoo")
    if dev.type == "cpu":
        return dsc_fcoo_plain(atoms, fibers, values, ranks, dictionary, w,
                              seg_k=seg_k)
    n_atoms, n_theta = dictionary.shape
    out = torch.empty((n_chunks, seg_k, n_theta), dtype=torch.float32,
                      device=dev)
    lib = _build.load("dsc_fcoo",
                      {name: _DSC_SIGNATURE for name in _DSC_ENTRY.values()})
    _build.launch(lib, _DSC_ENTRY[dictionary.dtype], "dsc_fcoo", dev,
                  [atoms, fibers, values, ranks, dictionary, w, out],
                  [n_chunks, c_tile, seg_k, n_atoms, n_theta])
    return out


# ----------------------------------------------------------------------------
# B6: F-COO WC
# ----------------------------------------------------------------------------

def wc_fcoo_plain(wc_perm, atoms, voxels, values, ranks, dictionary, y, *,
                  seg_k: int) -> torch.Tensor:
    """Plain PyTorch version of B6: gathers through ``wc_perm``, row dot
    products and one ``index_add_`` onto the (chunk, rank) partials."""
    n_chunks, _ = wc_perm.shape
    j = wc_perm.long()
    dots = (dictionary[atoms[j]].float() * y[voxels[j]]).sum(dim=-1)
    out = torch.zeros((n_chunks * seg_k,), dtype=torch.float32,
                      device=y.device)
    out.index_add_(0, _slot_segments(ranks, seg_k),
                   (dots * values[j].float()).reshape(-1))
    return out.reshape(n_chunks, seg_k)


def wc_fcoo(wc_perm, atoms, voxels, values, ranks, dictionary, y, *,
            seg_k: int) -> torch.Tensor:
    """Run B6 on CUDA tensors; on CPU tensors, the plain version.

    Raises:
        ValueError, TypeError: an operand on another device, of another
            dtype or shape, or not contiguous.
        RuntimeError: the CUDA launch was refused.
    """
    dev = y.device
    n_chunks, c_tile = wc_perm.shape
    n_padded = n_chunks * c_tile
    for name, t in (("wc_perm", wc_perm), ("ranks", ranks)):
        _build.check_operand(t, name, device=dev, dtypes=(torch.int32,),
                             shape=(n_chunks, c_tile))
    for name, t in (("atoms", atoms), ("voxels", voxels)):
        _build.check_operand(t, name, device=dev, dtypes=(torch.int32,),
                             shape=(n_padded,))
    _check_dictionary(dictionary, dev)
    _build.check_operand(values, "values", device=dev,
                         dtypes=(dictionary.dtype,), shape=(n_padded,))
    _build.check_operand(y, "y", device=dev, dtypes=(torch.float32,),
                         shape=(None, dictionary.shape[1]))
    _check_seg_k(seg_k, c_tile)
    dev = _device_of(y, "wc_fcoo")
    if dev.type == "cpu":
        return wc_fcoo_plain(wc_perm, atoms, voxels, values, ranks,
                             dictionary, y, seg_k=seg_k)
    n_atoms, n_theta = dictionary.shape
    out = torch.empty((n_chunks, seg_k), dtype=torch.float32, device=dev)
    lib = _build.load("wc_fcoo",
                      {name: _WC_SIGNATURE for name in _WC_ENTRY.values()})
    _build.launch(lib, _WC_ENTRY[dictionary.dtype], "wc_fcoo", dev,
                  [wc_perm, atoms, voxels, values, ranks, dictionary, y, out],
                  [n_chunks, c_tile, seg_k, n_atoms, n_theta])
    return out
