"""The two LiFE SpMV operations in plain PyTorch (executor layer).

Torch counterpart of ``repro/core/spmv.py``, the paper's Figure-3 ops as
separate code versions:

  * ``*_naive``        — direct translation: per-coefficient gather and
                         ``index_add_`` scatter (the ``naive`` executor).
  * ``dsc`` / ``wc``   — restructured executors: a dense (Nc, Ntheta)
                         contribution stream reduced by a *sorted* segment
                         sum over the output dimension (the ``opt`` executor).
  * ``*_atom_sorted``  — the paper's atom-sorted variants, unsorted scatter
                         (the ``opt-paper`` executor's WC).

With bf16-stored static operands (dictionary, Phi values) and fp32 dynamic
operands (``w``, ``Y``) every product promotes to fp32 before a reduction,
as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.std import PhiTensor


# ----------------------------------------------------------------------------
# Naive code versions (paper Figure 3): per-coefficient indirect ops.
# ----------------------------------------------------------------------------

def dsc_naive(phi: PhiTensor, dictionary: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """y = M w via scatter-add, no restructuring assumed. (Nv, Ntheta)."""
    scaled = w[phi.fibers] * phi.values                        # hoisted w*val
    contrib = dictionary[phi.atoms] * scaled[:, None]          # (Nc, Ntheta)
    out = torch.zeros((phi.n_voxels, dictionary.shape[1]),
                      dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, phi.voxels, contrib)


def wc_naive(phi: PhiTensor, dictionary: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """w = M^T y via gather-dot-scatter, no restructuring assumed. (Nf,)."""
    dots = (dictionary[phi.atoms] * y[phi.voxels]).sum(dim=1)
    vals = dots * phi.values
    out = torch.zeros((phi.n_fibers,), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, phi.fibers, vals)


# ----------------------------------------------------------------------------
# Restructured executors (paper §4.1.2 + §4.1.3): sorted segment reduction.
# ----------------------------------------------------------------------------

def segment_lengths(sorted_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Run length of every output id 0..num_segments-1 (zeros included).

    Inspector work: computed once per sorted Phi and passed to ``dsc`` /
    ``wc``, so the solver loop never waits on the device to size it."""
    return torch.bincount(sorted_ids.long(), minlength=num_segments)


def segment_sum_sorted(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sum consecutive runs of ``data`` rows; empty runs give zeros."""
    return torch.segment_reduce(data, "sum", lengths=lengths, unsafe=True)


def dsc(phi_sorted: PhiTensor, dictionary: torch.Tensor, w: torch.Tensor,
        lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = M w assuming coefficients sorted by voxel (restructured).

    ``lengths`` is ``segment_lengths(phi_sorted.voxels, n_voxels)``,
    computed here when not given."""
    if lengths is None:
        lengths = segment_lengths(phi_sorted.voxels, phi_sorted.n_voxels)
    scaled = w[phi_sorted.fibers] * phi_sorted.values
    contrib = dictionary[phi_sorted.atoms] * scaled[:, None]
    return segment_sum_sorted(contrib, lengths)


def wc(phi_sorted: PhiTensor, dictionary: torch.Tensor, y: torch.Tensor,
       lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w = M^T y assuming coefficients sorted by fiber.

    ``lengths`` is ``segment_lengths(phi_sorted.fibers, n_fibers)``,
    computed here when not given."""
    if lengths is None:
        lengths = segment_lengths(phi_sorted.fibers, phi_sorted.n_fibers)
    dots = (dictionary[phi_sorted.atoms] * y[phi_sorted.voxels]).sum(dim=1)
    return segment_sum_sorted(dots * phi_sorted.values, lengths)


def wc_atom_sorted(phi_sorted: PhiTensor, dictionary: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """Paper-faithful WC: atom-sorted (D reuse), unsorted fiber scatter."""
    return wc_naive(phi_sorted, dictionary, y)


def dsc_atom_sorted(phi_sorted: PhiTensor, dictionary: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Paper Table-2 variant: DSC with atom-sorted data (D reuse, unsorted Y)."""
    return dsc_naive(phi_sorted, dictionary, w)
