"""Synthetic dMRI / tractography generator (DS1/DS2 analogue).

Torch counterpart of ``repro/data/dmri.py``.  The paper evaluates on STN96
(Ntheta=96, Nv ~ 1.4-2.6e5, Nf = 5e4-5e5) with candidate connectomes from
five MRtrix tractography algorithms; this module synthesizes connectomes
with matching structure: streamlines stepped through a voxel grid, each
traversed (voxel, orientation) pair quantized to the nearest dictionary
atom, coefficients deduped, and ``b = M w_true + noise`` for a sparse
nonnegative ``w_true``.

The generator draws from the same ``numpy.random.default_rng(seed)`` stream
in the same order as the reference, so for one seed the Phi arrays and
``w_true`` equal the reference's array for array.  The dictionary does not
(see :func:`repro_torch.core.std.make_dictionary`); pass the reference's as
``dictionary=`` to reproduce its ``b`` as well.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import spmv
from repro_torch.core.std import PhiTensor, _fibonacci_sphere, make_dictionary
from repro_torch.device import DeviceLike, resolve_device

TRACTOGRAPHY = {
    # name: (curvature, mean_len, len_jitter)
    "DET": (0.05, 24, 4),
    "PROB": (0.35, 24, 8),
    "iFOD1": (0.50, 36, 12),
    "SD_STREAM": (0.20, 20, 6),
    "FACT": (0.00, 16, 4),
}


@dataclasses.dataclass
class LifeProblem:
    phi: PhiTensor
    dictionary: torch.Tensor     # (Na, Ntheta)
    b: torch.Tensor              # (Nv, Ntheta) demeaned measured signal
    w_true: torch.Tensor         # (Nf,) ground truth weights
    stats: Dict[str, float]
    # (gx, gy, gz) voxel-grid shape when voxel ids are a row-major box
    # linearization (set by synth_connectome); None otherwise.
    grid: Optional[Tuple[int, int, int]] = None

    def to(self, device: DeviceLike) -> "LifeProblem":
        """The same problem on ``device`` (no copy when already there)."""
        return dataclasses.replace(
            self, phi=self.phi.to(device),
            dictionary=self.dictionary.to(device), b=self.b.to(device),
            w_true=self.w_true.to(device))


def problem_stats(atoms: np.ndarray, voxels: np.ndarray,
                  n_fibers: int) -> Dict[str, float]:
    """Size statistics of a Phi, as the reference's generator records them."""
    nc = int(atoms.size)
    return dict(
        n_coeffs=float(nc),
        n_voxels_touched=float(np.unique(voxels).size),
        phi_mbytes=float(nc * (3 * 4 + 4)) / 1e6,
        nnz_per_fiber=float(nc) / max(1, n_fibers),
    )


def synth_connectome(
    *,
    n_fibers: int = 512,
    n_theta: int = 96,
    n_atoms: int = 96,
    grid: Tuple[int, int, int] = (24, 24, 24),
    algorithm: str = "PROB",
    noise: float = 0.01,
    active_frac: float = 0.35,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    dictionary: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> LifeProblem:
    """Synthetic LiFE problem on ``device`` (the CUDA card by default).

    ``dictionary`` replaces the port's own :func:`make_dictionary` (the
    cross-package tests pass the reference's)."""
    if algorithm not in TRACTOGRAPHY:
        raise ValueError(f"unknown tractography {algorithm!r}")
    dev = resolve_device(device)
    curvature, mean_len, jitter = TRACTOGRAPHY[algorithm]
    rng = np.random.default_rng(seed)
    gx, gy, gz = grid
    n_voxels = gx * gy * gz
    atom_dirs = _fibonacci_sphere(n_atoms)

    atoms, voxels, fibers, values = [], [], [], []
    step = 0.75
    for f in range(n_fibers):
        pos = rng.uniform([2, 2, 2], [gx - 2, gy - 2, gz - 2])
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        n_steps = max(4, int(rng.normal(mean_len, jitter)))
        for _ in range(n_steps):
            if curvature > 0:
                d = d + curvature * rng.normal(size=3)
                d /= np.linalg.norm(d)
            elif algorithm == "FACT":
                # axis-aligned steps (fiber assignment by continuous tracking)
                ax = np.argmax(np.abs(d))
                d = np.zeros(3)
                d[ax] = 1.0
            pos = pos + step * d
            v = np.floor(pos).astype(np.int64)
            if np.any(v < 0) or v[0] >= gx or v[1] >= gy or v[2] >= gz:
                break
            vox = int(v[0] * gy * gz + v[1] * gz + v[2])
            atom = int(np.argmax(np.abs(atom_dirs @ d)))  # axial symmetry
            atoms.append(atom)
            voxels.append(vox)
            fibers.append(f)
            values.append(step)

    atoms_a = np.asarray(atoms, np.int64)
    voxels_a = np.asarray(voxels, np.int64)
    fibers_a = np.asarray(fibers, np.int64)
    values_a = np.asarray(values, np.float64)

    # dedupe repeated (atom, voxel, fiber) triples, summing values
    key = (atoms_a * n_voxels + voxels_a) * n_fibers + fibers_a
    uniq, inv = np.unique(key, return_inverse=True)
    val_sum = np.zeros(uniq.size, np.float64)
    np.add.at(val_sum, inv, values_a)
    atoms_u = (uniq // n_fibers) // n_voxels
    voxels_u = (uniq // n_fibers) % n_voxels
    fibers_u = uniq % n_fibers

    phi = PhiTensor(
        atoms=torch.as_tensor(atoms_u, dtype=torch.int32, device=dev),
        voxels=torch.as_tensor(voxels_u, dtype=torch.int32, device=dev),
        fibers=torch.as_tensor(fibers_u, dtype=torch.int32, device=dev),
        values=torch.as_tensor(val_sum, dtype=dtype, device=dev),
        n_atoms=n_atoms, n_voxels=n_voxels, n_fibers=n_fibers,
    )
    if dictionary is None:
        dictionary = make_dictionary(n_atoms, n_theta, dtype=dtype, device=dev)
    else:
        dictionary = dictionary.to(device=dev, dtype=dtype)

    w_true = rng.uniform(0.0, 1.0, n_fibers)
    w_true[rng.uniform(size=n_fibers) > active_frac] = 0.0
    w_true_t = torch.as_tensor(w_true, dtype=dtype, device=dev)
    clean = spmv.dsc_naive(phi, dictionary, w_true_t)
    b = clean + noise * torch.as_tensor(rng.normal(size=tuple(clean.shape)),
                                        dtype=dtype, device=dev)
    return LifeProblem(phi=phi, dictionary=dictionary, b=b, w_true=w_true_t,
                       stats=problem_stats(atoms_u, voxels_u, n_fibers),
                       grid=grid)
