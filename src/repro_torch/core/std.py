"""Sparse Tucker Decomposition (STD) encoding of the LiFE matrix M.

The ENCODE representation (Caiafa & Pestilli 2017) stores the connectome
matrix ``M in R^{Ntheta*Nv x Nf}`` as a dictionary ``D in R^{Na x Ntheta}``
of canonical diffusion atoms and a sparse third-order tensor ``Phi`` with
``Nc`` nonzero coefficients, each a triple of indirection indices
``(atom_k, voxel_k, fiber_k)`` plus a value ``val_k``.  The two SpMVs of
SBBNNLS become (Figure 3 of the paper):

  DSC  (y = M w):    Y[voxel_k, :] += D[atom_k, :] * w[fiber_k] * val_k
  WC   (w = M^T y):  w[fiber_k]    += val_k * <D[atom_k, :], Y[voxel_k, :]>

Torch counterpart of ``repro/core/std.py``: the PhiTensor container, the
dense materialization used as the test oracle, and the synthetic dictionary.
Indices are int32, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Index = Union[torch.Tensor, np.ndarray]


@dataclasses.dataclass(frozen=True)
class PhiTensor:
    """COO sparse Tucker core of the LiFE matrix.

    atoms, voxels, fibers: int32[Nc] indirection vectors on one device.
    values: float[Nc] coefficient values.
    n_atoms / n_voxels / n_fibers: dimension sizes.
    """

    atoms: torch.Tensor
    voxels: torch.Tensor
    fibers: torch.Tensor
    values: torch.Tensor
    n_atoms: int
    n_voxels: int
    n_fibers: int

    @property
    def n_coeffs(self) -> int:
        return int(self.values.shape[0])

    @property
    def device(self) -> torch.device:
        return self.values.device

    def astype(self, dtype: torch.dtype) -> "PhiTensor":
        return dataclasses.replace(self, values=self.values.to(dtype))

    def to(self, device: DeviceLike) -> "PhiTensor":
        """The same tensor on ``device`` (no copy when already there)."""
        return dataclasses.replace(
            self, atoms=self.atoms.to(device), voxels=self.voxels.to(device),
            fibers=self.fibers.to(device), values=self.values.to(device))

    def take(self, order: Index) -> "PhiTensor":
        """Reorder coefficients (the paper's data restructuring primitive)."""
        idx = torch.as_tensor(order, device=self.device).long()
        return dataclasses.replace(
            self,
            atoms=self.atoms[idx],
            voxels=self.voxels[idx],
            fibers=self.fibers[idx],
            values=self.values[idx],
        )

    def validate(self) -> None:
        """Raise ValueError when an index lies outside its dimension."""
        for name, ids, n in (("atom", self.atoms, self.n_atoms),
                             ("voxel", self.voxels, self.n_voxels),
                             ("fiber", self.fibers, self.n_fibers)):
            a = ids.cpu().numpy()
            if a.size and (a.min() < 0 or a.max() >= n):
                raise ValueError(f"{name} index out of range")


def materialize_dense(phi: PhiTensor, dictionary: torch.Tensor) -> torch.Tensor:
    """Dense M in R^{(Nv*Ntheta) x Nf}; oracle only — O(Nv*Ntheta*Nf) memory.

    M[v*Ntheta + t, f] = sum over coefficients k with (voxel_k=v, fiber_k=f)
                         of D[atom_k, t] * val_k
    """
    n_theta = dictionary.shape[1]
    dev = dictionary.device
    m = torch.zeros((phi.n_voxels * n_theta, phi.n_fibers),
                    dtype=dictionary.dtype, device=dev)
    rows = (phi.voxels.long()[:, None] * n_theta
            + torch.arange(n_theta, device=dev)[None, :])
    cols = phi.fibers.long()[:, None].expand_as(rows)
    vals = dictionary[phi.atoms.long()] * phi.values[:, None]
    return m.index_put_((rows.reshape(-1), cols.reshape(-1)),
                        vals.reshape(-1).to(m.dtype), accumulate=True)


def demean_signal(y: torch.Tensor, n_theta: int) -> torch.Tensor:
    """Per-voxel demeaning of the measured diffusion signal (LiFE convention)."""
    y2 = y.reshape(-1, n_theta)
    return (y2 - y2.mean(dim=1, keepdim=True)).reshape(-1)


def make_dictionary(n_atoms: int, n_theta: int, *, seed: int = 7,
                    dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None) -> torch.Tensor:
    """Synthetic canonical-atom dictionary (Na, Ntheta).

    Atoms model stick-like diffusion responses along quasi-uniform 3-D
    orientations, evaluated against Ntheta gradient directions and demeaned
    per atom.  The gradient directions come from
    ``numpy.random.default_rng(seed)``, where the reference draws them from
    ``jax.random.PRNGKey(7)``: the two dictionaries differ.  Tests that hold
    the port against the reference therefore carry the reference's
    dictionary across (:mod:`repro_torch.bridge`) instead of regenerating it.
    """
    dev = resolve_device(device)
    atom_dirs = _fibonacci_sphere(n_atoms)
    grad_dirs = np.random.default_rng(seed).normal(size=(n_theta, 3))
    grad_dirs /= np.linalg.norm(grad_dirs, axis=1, keepdims=True)
    # Stick model: S(theta) = exp(-b * d * (g . n)^2)
    cos2 = (grad_dirs @ atom_dirs.T) ** 2  # (Ntheta, Na)
    sig = np.exp(-2.0 * cos2).T  # (Na, Ntheta)
    sig = sig - sig.mean(axis=1, keepdims=True)
    return torch.as_tensor(np.ascontiguousarray(sig), dtype=dtype, device=dev)


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
        axis=1,
    )
