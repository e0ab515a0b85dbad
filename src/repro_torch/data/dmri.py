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
``w_true`` equal the reference's array for array.  The dictionary is the
reference's to float32 rounding (:func:`repro_torch.core.std.make_dictionary`
reproduces its JAX-drawn gradient directions), and so is ``b``.

:func:`coarsen_problem` (multi-resolution levels) and :func:`fiber_bundles`
(virtual-lesion bundles) serve the science workloads
(:mod:`repro_torch.science`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

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

    ``dictionary`` replaces the default :func:`make_dictionary`, which is
    already the reference's."""
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


def synth_cohort(n_subjects: int, *, base_seed: int = 0,
                 algorithm: str = "PROB", **kwargs) -> List[LifeProblem]:
    """Cohort of subjects sharing the acquisition, varying the anatomy.

    Subject ``s`` is ``synth_connectome(seed=base_seed + s, ...)``, so the
    cohort is the reference's array for array.  All subjects share grid,
    n_fibers, n_theta and n_atoms, and so the same dictionary; their
    streamlines differ, so their coefficient counts Nc differ, which is
    the padding :class:`~repro_torch.core.batched.BatchedLifeEngine`
    absorbs.
    """
    return [synth_connectome(seed=base_seed + s, algorithm=algorithm,
                             **kwargs) for s in range(n_subjects)]


def coarsen_problem(problem: LifeProblem, factor: int, *,
                    grid: Optional[Tuple[int, int, int]] = None
                    ) -> LifeProblem:
    """Voxel-coarsened problem for coarse-to-fine multi-resolution solves.

    Merges every ``factor^3`` block of fine voxels into one coarse voxel:
    Phi coefficients are remapped and deduped (values summed, like the
    generator's own dedupe), and the signal rows of merged voxels are
    summed, so the coarse clean signal is exactly the sum of the fine
    clean signals and the fiber id space is untouched.  A coarse solve's
    weights therefore warm-start the fine solve directly
    (:func:`repro_torch.science.incremental.multires_solve`).  The
    remapping runs in numpy on the host, as the reference's does; the
    result's tensors lie on the problem's device.

    Args:
        problem: the fine problem; needs a voxel grid.
        factor: coarsening factor per axis; 1 returns the input.
        grid: grid override when ``problem.grid`` is unset.

    Returns:
        The coarsened :class:`LifeProblem` (its ``grid`` is the coarse
        box).

    Raises:
        ValueError: if ``factor < 1`` or no grid is available.
    """
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    if factor == 1:
        return problem
    g = grid if grid is not None else problem.grid
    if g is None:
        raise ValueError("coarsen_problem needs a voxel grid: the problem "
                         "has grid=None and no grid= was given")
    gx, gy, gz = g
    cgx, cgy, cgz = (-(-gx // factor), -(-gy // factor), -(-gz // factor))
    phi = problem.phi
    if gx * gy * gz != phi.n_voxels:
        raise ValueError(f"grid {g} does not linearize to "
                         f"n_voxels={phi.n_voxels}")

    def to_coarse(vox: np.ndarray) -> np.ndarray:
        x, rem = vox // (gy * gz), vox % (gy * gz)
        y, z = rem // gz, rem % gz
        return ((x // factor) * cgy + (y // factor)) * cgz + (z // factor)

    dev = phi.device
    atoms = phi.atoms.cpu().numpy().astype(np.int64)
    cvox = to_coarse(phi.voxels.cpu().numpy().astype(np.int64))
    fibers = phi.fibers.cpu().numpy().astype(np.int64)
    values = phi.values.cpu().double().numpy()
    n_cvox = cgx * cgy * cgz
    key = (atoms * n_cvox + cvox) * phi.n_fibers + fibers
    uniq, inv = np.unique(key, return_inverse=True)
    val_sum = np.zeros(uniq.size, np.float64)
    np.add.at(val_sum, inv, values)

    def idx(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    sub = PhiTensor(
        atoms=idx((uniq // phi.n_fibers) // n_cvox),
        voxels=idx((uniq // phi.n_fibers) % n_cvox),
        fibers=idx(uniq % phi.n_fibers),
        values=torch.as_tensor(val_sum, dtype=phi.values.dtype, device=dev),
        n_atoms=phi.n_atoms, n_voxels=n_cvox, n_fibers=phi.n_fibers)
    b = problem.b
    b_coarse = np.zeros((n_cvox, b.shape[1]), np.float64)
    np.add.at(b_coarse, to_coarse(np.arange(gx * gy * gz, dtype=np.int64)),
              b.cpu().double().numpy())
    stats = dict(problem.stats)
    stats["n_coeffs"] = float(sub.n_coeffs)
    stats["n_voxels_touched"] = float(np.unique(
        (uniq // phi.n_fibers) % n_cvox).size)
    return LifeProblem(phi=sub, dictionary=problem.dictionary,
                       b=torch.as_tensor(b_coarse, dtype=b.dtype, device=dev),
                       w_true=problem.w_true, stats=stats,
                       grid=(cgx, cgy, cgz))


def fiber_bundles(problem: LifeProblem, *, bundle_size: int,
                  n_bundles: int = 1, seed: int = 0) -> List[np.ndarray]:
    """Disjoint, spatially coherent fiber bundles (lesion candidates).

    Each bundle is a seed fiber plus its ``bundle_size - 1`` nearest
    neighbours by coefficient-centroid distance (3-D positions when the
    problem has a grid, linear voxel ids otherwise), a synthetic stand-in
    for an anatomically grouped tract.  Only fibers with at least one Phi
    coefficient are eligible, and bundles never overlap.  Host numpy, as
    the reference's, so one seed gives the reference's bundles.

    Args:
        problem: the problem to draw bundles from.
        bundle_size: fibers per bundle.
        n_bundles: number of disjoint bundles.
        seed: RNG seed for the bundle seed-fiber draw.

    Returns:
        ``n_bundles`` sorted int64 arrays of ``bundle_size`` fiber ids.

    Raises:
        ValueError: when fewer than ``n_bundles * bundle_size`` fibers
            have coefficients.
    """
    fib = problem.phi.fibers.cpu().numpy().astype(np.int64)
    vox = problem.phi.voxels.cpu().numpy().astype(np.int64)
    if problem.grid is not None:
        gx, gy, gz = problem.grid
        pos = np.stack([vox // (gy * gz), (vox // gz) % gy, vox % gz],
                       axis=1).astype(np.float64)
    else:
        pos = vox[:, None].astype(np.float64)
    counts = np.bincount(fib, minlength=problem.phi.n_fibers)
    sums = np.zeros((problem.phi.n_fibers, pos.shape[1]))
    np.add.at(sums, fib, pos)
    structural = np.nonzero(counts > 0)[0]
    if structural.size < n_bundles * bundle_size:
        raise ValueError(
            f"need {n_bundles * bundle_size} fibers with coefficients, "
            f"have {structural.size}")
    centroids = sums[structural] / counts[structural, None]
    rng = np.random.default_rng(seed)
    available = np.ones(structural.size, bool)
    bundles: List[np.ndarray] = []
    for _ in range(n_bundles):
        pool = np.nonzero(available)[0]
        anchor = rng.choice(pool)
        d = np.linalg.norm(centroids - centroids[anchor], axis=1)
        d[~available] = np.inf
        members = np.argsort(d, kind="stable")[:bundle_size]
        available[members] = False
        bundles.append(np.sort(structural[members]))
    return bundles
