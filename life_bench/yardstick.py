"""The yardstick: the card's published peaks and the least bytes an SpMV
of LiFE has to move, whatever layout implements it.

The count is frozen here so that a later layout cannot move its own
yardstick.  Per coefficient it counts one int32 atom, one int32
input-side index and one value in the storage dtype; the output-side
index as one int32 pointer per output row; the dictionary ``D``, the
dense input and the exact output once each.  For a cohort the subjects'
terms are summed and the shared dictionary is counted once.
"""
from __future__ import annotations

#: NVIDIA H100 SXM, published (data sheet, 700 W): HBM3 bytes/s and dense
#: bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

INDEX_BYTES = 4
VALUE_BYTES = {"fp32": 4, "bf16": 2}
DENSE_BYTES = 4          # w, Y and b stay float32 in every storage dtype


def dsc_bytes(n_coeffs: int, n_voxels: int, n_fibers: int, n_atoms: int,
              n_theta: int, *, subjects: int = 1,
              storage: str = "fp32") -> int:
    """Least bytes of one ``y = M w`` over ``subjects`` subjects holding
    ``n_coeffs`` coefficients between them."""
    per_coeff = 2 * INDEX_BYTES + VALUE_BYTES[storage]
    return (n_coeffs * per_coeff
            + subjects * n_voxels * INDEX_BYTES            # row pointers
            + n_atoms * n_theta * VALUE_BYTES[storage]     # D
            + subjects * n_fibers * DENSE_BYTES            # w
            + subjects * n_voxels * n_theta * DENSE_BYTES)  # Y


def wc_bytes(n_coeffs: int, n_voxels: int, n_fibers: int, n_atoms: int,
             n_theta: int, *, subjects: int = 1,
             storage: str = "fp32") -> int:
    """Least bytes of one ``w = Mᵀ y`` over ``subjects`` subjects."""
    per_coeff = 2 * INDEX_BYTES + VALUE_BYTES[storage]
    return (n_coeffs * per_coeff
            + subjects * n_fibers * INDEX_BYTES             # row pointers
            + n_atoms * n_theta * VALUE_BYTES[storage]      # D
            + subjects * n_voxels * n_theta * DENSE_BYTES   # Y
            + subjects * n_fibers * DENSE_BYTES)            # w


def hbm_seconds(n_bytes: float) -> float:
    """The least time ``n_bytes`` take at the card's published HBM rate."""
    return n_bytes / HBM_BYTES_PER_S
