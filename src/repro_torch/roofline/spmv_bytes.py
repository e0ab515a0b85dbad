"""Compulsory bytes and operations of the two LiFE SpMVs, by layout.

The reference counts an engine's bytes in the compiled HLO of its SpMV
pair (``repro/roofline/hlo_cost.py``).  The port has no HLO, so it counts
the work analytically: what the function must move whatever executor
computes it.  Each index and value of a real coefficient is read once,
the layout's per-row or per-tile metadata once, the dictionary ``D`` and
the dense input (``w`` for DSC ``y = M w``, ``Y`` for WC ``w = Mᵀ y``) once,
and the output written once.  The operations are ``2 Nc Ntheta + Nc``: a
dot of a dictionary row with ``Y`` (or a scaled row added to ``y``) and
the scale, per coefficient.

One function per kernel layout, plus the plain executors' coordinate
stream:

  COO tiles (B1/B2)  atoms, input-side index, value, local row per slot;
                     ``tile_ptr`` and ``tile_len``; the padded output
  SELL (B3/B4)       atoms, input-side index, value per slot; ``row_nnz``;
                     the padded output rows
  stream             atoms, voxels, fibers, value per coefficient; the
                     exact output: both ops of the plain executors, and
                     B5's DSC over the F-COO stream
  F-COO WC (B6)      the stream with ``wc_perm`` and ``wc_fibers``

Indices are int32; ``w``, ``Y`` and the outputs float32; values and ``D``
in their storage dtype (``value_bytes``, ``d_bytes``).  ``chip_smoke.py``
phase 6 takes its kernels' bounds from here, and ``LifeEngine`` its
``engine.roofline.fraction`` gauge, weighted per SBBNNLS iteration by
:func:`iteration_bytes`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

INDEX_BYTES = 4        # int32 indices, lengths and pointers
FLOAT_BYTES = 4        # float32 w, Y and outputs


@dataclasses.dataclass(frozen=True)
class Work:
    """Compulsory bytes and operations of one SpMV call."""

    bytes: float
    flops: float


def spmv_flops(nc: int, n_theta: int) -> float:
    return 2.0 * nc * n_theta + nc


def dsc_coo(nc: int, n_theta: int, *, n_fibers: int, n_row_blocks: int,
            n_tiles: int, row_tile: int, d_bytes: int,
            value_bytes: int = FLOAT_BYTES) -> Work:
    slot = 3 * INDEX_BYTES + value_bytes
    meta = INDEX_BYTES * (n_row_blocks + 1 + n_tiles)
    return Work(nc * slot + meta + n_fibers * FLOAT_BYTES
                + n_row_blocks * row_tile * n_theta * FLOAT_BYTES + d_bytes,
                spmv_flops(nc, n_theta))


def wc_coo(nc: int, n_theta: int, *, n_voxels: int, n_row_blocks: int,
           n_tiles: int, row_tile: int, d_bytes: int,
           value_bytes: int = FLOAT_BYTES) -> Work:
    slot = 3 * INDEX_BYTES + value_bytes
    meta = INDEX_BYTES * (n_row_blocks + 1 + n_tiles)
    return Work(nc * slot + meta + n_voxels * n_theta * FLOAT_BYTES
                + n_row_blocks * row_tile * FLOAT_BYTES + d_bytes,
                spmv_flops(nc, n_theta))


def dsc_sell(nc: int, n_theta: int, *, n_fibers: int, n_rows: int,
             rows_padded: int, d_bytes: int,
             value_bytes: int = FLOAT_BYTES) -> Work:
    slot = 2 * INDEX_BYTES + value_bytes
    return Work(nc * slot + n_rows * INDEX_BYTES + n_fibers * FLOAT_BYTES
                + rows_padded * n_theta * FLOAT_BYTES + d_bytes,
                spmv_flops(nc, n_theta))


def wc_sell(nc: int, n_theta: int, *, n_voxels: int, n_rows: int,
            rows_padded: int, d_bytes: int,
            value_bytes: int = FLOAT_BYTES) -> Work:
    slot = 2 * INDEX_BYTES + value_bytes
    return Work(nc * slot + n_rows * INDEX_BYTES
                + n_voxels * n_theta * FLOAT_BYTES
                + rows_padded * FLOAT_BYTES + d_bytes,
                spmv_flops(nc, n_theta))


def stream(nc: int, n_theta: int, *, n_voxels: int, n_fibers: int,
           d_bytes: int, value_bytes: int = FLOAT_BYTES) -> Work:
    """One pass over a coordinate stream (atoms, voxels, fibers, value per
    coefficient) reading the dense input and writing the exact output:
    either op of a plain executor, and B5's DSC over the F-COO stream."""
    slot = 3 * INDEX_BYTES + value_bytes
    return Work(nc * slot + n_fibers * FLOAT_BYTES
                + n_voxels * n_theta * FLOAT_BYTES + d_bytes,
                spmv_flops(nc, n_theta))


def wc_fcoo(nc: int, n_theta: int, *, n_voxels: int, n_fibers: int,
            d_bytes: int, value_bytes: int = FLOAT_BYTES) -> Work:
    """B6: the stream read through ``wc_perm``, with ``wc_fibers``."""
    slot = 4 * INDEX_BYTES + value_bytes
    return Work(nc * slot + n_voxels * n_theta * FLOAT_BYTES
                + n_fibers * FLOAT_BYTES + d_bytes,
                spmv_flops(nc, n_theta))


def executor_work(executor, phi, n_theta: int, n_atoms: int,
                  compute_dtype: str = "fp32") -> Tuple[Work, Work]:
    """(DSC, WC) work of one call of each of ``executor``'s ops over
    ``phi``: the kernel executors' layouts from their plans, every other
    executor the coordinate stream."""
    value_bytes = 2 if compute_dtype == "bf16" else FLOAT_BYTES
    kw = dict(d_bytes=n_atoms * n_theta * value_bytes,
              value_bytes=value_bytes)
    nv, nf, plans = phi.n_voxels, phi.n_fibers, executor.plans
    if executor.name == "kernel":
        dp, wp = plans["dsc_tiles"], plans["wc_tiles"]
        return (dsc_coo(dp.n_coeffs, n_theta, n_fibers=nf,
                        n_row_blocks=dp.n_rows_padded // dp.row_tile,
                        n_tiles=dp.n_tiles, row_tile=dp.row_tile, **kw),
                wc_coo(wp.n_coeffs, n_theta, n_voxels=nv,
                       n_row_blocks=wp.n_rows_padded // wp.row_tile,
                       n_tiles=wp.n_tiles, row_tile=wp.row_tile, **kw))
    if executor.name == "kernel-sell":
        sd, sw = plans["sell_dsc"], plans["sell_wc"]
        return (dsc_sell(sd.n_coeffs, n_theta, n_fibers=nf,
                         n_rows=sd.row_nnz.size,
                         rows_padded=sd.atoms.shape[0], **kw),
                wc_sell(sw.n_coeffs, n_theta, n_voxels=nv,
                        n_rows=sw.row_nnz.size,
                        rows_padded=sw.atoms.shape[0], **kw))
    if executor.name == "kernel-fcoo":
        nc = plans["fcoo"].n_coeffs
        return (stream(nc, n_theta, n_voxels=nv, n_fibers=nf, **kw),
                wc_fcoo(nc, n_theta, n_voxels=nv, n_fibers=nf, **kw))
    work = stream(phi.n_coeffs, n_theta, n_voxels=nv, n_fibers=nf, **kw)
    return work, work


def iteration_bytes(dsc: Work, wc: Work) -> float:
    """Bytes of one SBBNNLS iteration at the solver's op mix (DSC twice,
    WC on three iterations of two), the weighting the tuner measures
    under."""
    from repro_torch.tune.tuner import DSC_WEIGHT, WC_WEIGHT
    return DSC_WEIGHT * dsc.bytes + WC_WEIGHT * wc.bytes
