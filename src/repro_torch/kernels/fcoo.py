"""The F-COO kernels B5 (DSC) and B6 (WC): wrappers and plain versions.

``csrc/dsc_fcoo.cu`` (B5) replaces the Pallas TPU kernel
``repro/kernels/fcoo.py:dsc_fcoo_pallas`` and ``csrc/wc_fcoo.cu`` (B6)
replaces ``repro/kernels/fcoo.py:wc_fcoo_pallas``, each together with the
reference's scatter-add of its partials; each source's note says what
bounds it on the card and what its design does about that.

Both compute their op directly, ``y = M w`` and ``w = Mᵀ y``, with one
dataflow: segments (runs of equal output ids) inside a chunk are stored to
their output row, a chunk's first and last segments go to a carry buffer,
and an ordered fold adds the carries of runs that cross chunks, so no
output takes an atomic.  :func:`dsc_fcoo_fused_plain` and
:func:`wc_fcoo_fused_plain` are their plain versions, with the same
dataflow.  :func:`dsc_fcoo_plain` and :func:`wc_fcoo_plain` keep the Pallas
kernels' per-chunk segment partials slot for slot (zeros past a chunk's
last segment); the tests hold them against the Pallas kernels.  A wrapper
launches its kernel on CUDA tensors (counted in
:data:`repro_torch.kernels._build.LAUNCHES`), runs its plain PyTorch
version on CPU tensors, and raises on anything else.  Sums are taken in
float32 whatever the storage type.

Operands (one ``formats/fcoo.py:FcooPhi`` on the device, built by
:func:`repro_torch.kernels.ops.fcoo_operands`):

  B5: atoms, fibers, voxels  int32[n_chunks, c_tile]  the voxel-major
                                                      stream
      values    float32 | bfloat16 [n_chunks, c_tile]
      w         float32[Nf]
      result    float32[n_voxels, Ntheta]
  B6: wc_perm, wc_fibers    int32[n_chunks, c_tile]  the fiber-major view
                                                     and its fibers
      atoms, voxels  int32[Ncp]        the stream itself, read through
      values    float32 | bfloat16 [Ncp]   wc_perm inside the kernel
      y         float32[Nv, Ntheta]
      result    float32[n_fibers]

``dictionary`` is [Na, Ntheta] in the values' dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dsc import _device_of

_DSC_SIGNATURE = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p])
_DSC_ENTRY = {torch.float32: "dsc_fcoo_f32", torch.bfloat16: "dsc_fcoo_bf16"}
_WC_SIGNATURE = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])
_WC_ENTRY = {torch.float32: "wc_fcoo_f32", torch.bfloat16: "wc_fcoo_bf16"}


def _check_dictionary(dictionary, dev) -> None:
    _build.check_operand(dictionary, "dictionary", device=dev,
                         dtypes=(torch.float32, torch.bfloat16),
                         shape=(None, None))


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
    """The Pallas kernel's (n_chunks, seg_k, Ntheta) segment partials, in
    plain PyTorch: gathers and one ``index_add_`` of every slot's
    contribution onto its (chunk, rank) partial.  Not on the card path:
    B5 writes ``y`` (:func:`dsc_fcoo`)."""
    n_chunks, _ = atoms.shape
    n_theta = dictionary.shape[1]
    scaled = w[fibers] * values.float()
    contrib = dictionary[atoms].float() * scaled[..., None]
    out = torch.zeros((n_chunks * seg_k, n_theta), dtype=torch.float32,
                      device=w.device)
    out.index_add_(0, _slot_segments(ranks, seg_k),
                   contrib.reshape(-1, n_theta))
    return out.reshape(n_chunks, seg_k, n_theta)


def dsc_fcoo_fused_plain(atoms, fibers, values, voxels, dictionary, w, *,
                         n_voxels: int) -> torch.Tensor:
    """Plain PyTorch version of B5, ``y = M w`` with the kernel's dataflow:
    segment sums in slot order, interior segments stored to their voxel's
    row, each chunk's first and last segment carried (0.0 last for a chunk
    of one segment), and the carries of each run added in chunk order."""
    n_chunks, c_tile = atoms.shape
    n_theta = dictionary.shape[1]
    dev = w.device
    y = torch.zeros((n_voxels, n_theta), dtype=torch.float32, device=dev)
    if n_chunks == 0:
        return y
    contrib = dictionary[atoms].float() * (w[fibers]
                                           * values.float())[..., None]
    starts = torch.ones_like(voxels, dtype=torch.bool)
    starts[:, 1:] = voxels[:, 1:] != voxels[:, :-1]
    rank = starts.long().cumsum(1) - 1              # chunk-local segment
    chunk = torch.arange(n_chunks, device=dev)
    seg = torch.zeros((n_chunks * c_tile, n_theta), dtype=torch.float32,
                      device=dev)
    seg.index_add_(0, (chunk[:, None] * c_tile + rank).reshape(-1),
                   contrib.reshape(-1, n_theta))
    seg = seg.view(n_chunks, c_tile, n_theta)
    last = rank[:, -1]
    inner_c, inner_i = torch.nonzero(
        starts & (rank > 0) & (rank < last[:, None]), as_tuple=True)
    y[voxels[inner_c, inner_i].long()] = seg[inner_c, rank[inner_c, inner_i]]
    tail = torch.where((last > 0)[:, None], seg[chunk, last],
                       torch.zeros((), device=dev))
    carry = torch.stack([seg[:, 0], tail], 1).reshape(-1, n_theta)
    carry_vox = torch.stack([voxels[:, 0], voxels[:, -1]], 1).reshape(-1)
    run_start = torch.ones_like(carry_vox, dtype=torch.bool)
    run_start[1:] = carry_vox[1:] != carry_vox[:-1]
    run = run_start.long().cumsum(0) - 1
    runs = torch.zeros_like(carry).index_add_(0, run, carry)
    y[carry_vox[run_start].long()] = runs[run[run_start]]
    return y


def dsc_fcoo(atoms, fibers, values, voxels, dictionary, w, *,
             n_voxels: int) -> torch.Tensor:
    """Run B5, ``y = M w`` as (n_voxels, Ntheta) float32, on CUDA tensors;
    on CPU tensors, the plain version.

    Raises:
        ValueError, TypeError: an operand on another device, of another
            dtype or shape, or not contiguous; a negative ``n_voxels``.
        RuntimeError: the CUDA launch was refused.
    """
    dev = w.device
    n_chunks, c_tile = atoms.shape
    for name, t in (("atoms", atoms), ("fibers", fibers), ("voxels", voxels)):
        _build.check_operand(t, name, device=dev, dtypes=(torch.int32,),
                             shape=(n_chunks, c_tile))
    _check_dictionary(dictionary, dev)
    _build.check_operand(values, "values", device=dev,
                         dtypes=(dictionary.dtype,), shape=(n_chunks, c_tile))
    _build.check_operand(w, "w", device=dev, dtypes=(torch.float32,),
                         shape=(None,))
    if n_voxels < 0:
        raise ValueError(f"n_voxels={n_voxels} must be >= 0")
    dev = _device_of(w, "dsc_fcoo")
    if dev.type == "cpu":
        return dsc_fcoo_fused_plain(atoms, fibers, values, voxels,
                                    dictionary, w, n_voxels=n_voxels)
    n_atoms, n_theta = dictionary.shape
    y = torch.empty((n_voxels, n_theta), dtype=torch.float32, device=dev)
    carry = torch.empty((n_chunks, 2, n_theta), dtype=torch.float32,
                        device=dev)
    carry_vox = torch.empty((n_chunks, 2), dtype=torch.int32, device=dev)
    lib = _build.load("dsc_fcoo",
                      {name: _DSC_SIGNATURE for name in _DSC_ENTRY.values()})
    _build.launch(lib, _DSC_ENTRY[dictionary.dtype], "dsc_fcoo", dev,
                  [atoms, fibers, values, voxels, dictionary, w, y, carry,
                   carry_vox],
                  [n_chunks, c_tile, n_voxels, n_atoms, n_theta])
    return y


# ----------------------------------------------------------------------------
# B6: F-COO WC
# ----------------------------------------------------------------------------

def wc_fcoo_plain(wc_perm, atoms, voxels, values, ranks, dictionary, y, *,
                  seg_k: int) -> torch.Tensor:
    """The Pallas kernel's (n_chunks, seg_k) segment partials, in plain
    PyTorch: gathers through ``wc_perm``, row dot products and one
    ``index_add_`` onto the (chunk, rank) partials.  Not on the card path:
    B6 writes ``w`` (:func:`wc_fcoo`)."""
    n_chunks, _ = wc_perm.shape
    j = wc_perm.long()
    dots = (dictionary[atoms[j]].float() * y[voxels[j]]).sum(dim=-1)
    out = torch.zeros((n_chunks * seg_k,), dtype=torch.float32,
                      device=y.device)
    out.index_add_(0, _slot_segments(ranks, seg_k),
                   (dots * values[j].float()).reshape(-1))
    return out.reshape(n_chunks, seg_k)


def wc_fcoo_fused_plain(wc_perm, wc_fibers, atoms, voxels, values,
                        dictionary, y, *, n_fibers: int) -> torch.Tensor:
    """Plain PyTorch version of B6, ``w = Mᵀ y`` with the kernel's dataflow:
    segment sums in slot order, interior segments stored to their fiber,
    each chunk's first and last segment carried (0.0 last for a chunk of
    one segment), and the carries of each run added in chunk order."""
    n_chunks, c_tile = wc_perm.shape
    dev = y.device
    w = torch.zeros((n_fibers,), dtype=torch.float32, device=dev)
    if n_chunks == 0:
        return w
    j = wc_perm.long()
    prods = ((dictionary[atoms[j]].float() * y[voxels[j]]).sum(dim=-1)
             * values[j].float())
    starts = torch.ones_like(wc_fibers, dtype=torch.bool)
    starts[:, 1:] = wc_fibers[:, 1:] != wc_fibers[:, :-1]
    rank = starts.long().cumsum(1) - 1              # chunk-local segment
    chunk = torch.arange(n_chunks, device=dev)
    seg = torch.zeros((n_chunks * c_tile,), dtype=torch.float32, device=dev)
    seg.index_add_(0, (chunk[:, None] * c_tile + rank).reshape(-1),
                   prods.reshape(-1))
    seg = seg.view(n_chunks, c_tile)
    last = rank[:, -1]
    inner_c, inner_i = torch.nonzero(
        starts & (rank > 0) & (rank < last[:, None]), as_tuple=True)
    w[wc_fibers[inner_c, inner_i].long()] = seg[inner_c,
                                                rank[inner_c, inner_i]]
    tail = torch.where(last > 0, seg[chunk, last], torch.zeros((), device=dev))
    carry = torch.stack([seg[:, 0], tail], 1).reshape(-1)
    carry_fib = torch.stack([wc_fibers[:, 0], wc_fibers[:, -1]],
                            1).reshape(-1)
    run_start = torch.ones_like(carry_fib, dtype=torch.bool)
    run_start[1:] = carry_fib[1:] != carry_fib[:-1]
    run = run_start.long().cumsum(0) - 1
    runs = torch.zeros_like(carry).index_add_(0, run, carry)
    w[carry_fib[run_start].long()] = runs[run[run_start]]
    return w


def wc_fcoo(wc_perm, wc_fibers, atoms, voxels, values, dictionary, y, *,
            n_fibers: int) -> torch.Tensor:
    """Run B6, ``w = Mᵀ y`` as (n_fibers,) float32, on CUDA tensors; on CPU
    tensors, the plain version.

    Raises:
        ValueError, TypeError: an operand on another device, of another
            dtype or shape, or not contiguous; a negative ``n_fibers``.
        RuntimeError: the CUDA launch was refused.
    """
    dev = y.device
    n_chunks, c_tile = wc_perm.shape
    n_padded = n_chunks * c_tile
    for name, t in (("wc_perm", wc_perm), ("wc_fibers", wc_fibers)):
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
    if n_fibers < 0:
        raise ValueError(f"n_fibers={n_fibers} must be >= 0")
    dev = _device_of(y, "wc_fcoo")
    if dev.type == "cpu":
        return wc_fcoo_fused_plain(wc_perm, wc_fibers, atoms, voxels, values,
                                   dictionary, y, n_fibers=n_fibers)
    n_atoms, n_theta = dictionary.shape
    w = torch.empty((n_fibers,), dtype=torch.float32, device=dev)
    carry = torch.empty((n_chunks, 2), dtype=torch.float32, device=dev)
    carry_fib = torch.empty((n_chunks, 2), dtype=torch.int32, device=dev)
    lib = _build.load("wc_fcoo",
                      {name: _WC_SIGNATURE for name in _WC_ENTRY.values()})
    _build.launch(lib, _WC_ENTRY[dictionary.dtype], "wc_fcoo", dev,
                  [wc_perm, wc_fibers, atoms, voxels, values, dictionary, y,
                   w, carry, carry_fib],
                  [n_chunks, c_tile, n_fibers, n_atoms, n_theta])
    return w
