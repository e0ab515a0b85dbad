"""Numpy bridge between the reference package and the port.

The reference's problems, weights and solver states cross into the port as
numpy arrays (``np.asarray`` of the reference's arrays), never by importing
the reference: the port runs where JAX is not installed.  The reference's
dictionary comes from a JAX key that the port cannot reproduce
(:func:`repro_torch.core.std.make_dictionary`), so a test that holds the two
packages against each other builds its problem once, with the reference,
and hands the same arrays to both.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.std import PhiTensor
from repro_torch.data.dmri import LifeProblem, problem_stats
from repro_torch.device import DeviceLike, resolve_device


def from_reference(atoms, voxels, fibers, values, n_atoms: int,
                   n_voxels: int, n_fibers: int, dictionary, b, w_true, *,
                   device: DeviceLike = None,
                   grid: Optional[Tuple[int, int, int]] = None) -> LifeProblem:
    """The port's LifeProblem from the numpy arrays of a reference one.

    Index arrays become int32 and the float arrays keep their dtype
    (float32 in the reference's problems)."""
    dev = resolve_device(device)

    def idx(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)

    def flt(a):
        return torch.tensor(np.asarray(a), device=dev)

    phi = PhiTensor(atoms=idx(atoms), voxels=idx(voxels), fibers=idx(fibers),
                    values=flt(values), n_atoms=int(n_atoms),
                    n_voxels=int(n_voxels), n_fibers=int(n_fibers))
    phi.validate()
    return LifeProblem(
        phi=phi, dictionary=flt(dictionary), b=flt(b), w_true=flt(w_true),
        stats=problem_stats(np.asarray(atoms), np.asarray(voxels),
                            int(n_fibers)),
        grid=grid)


def weights_from_reference(w, *, device: DeviceLike = None) -> torch.Tensor:
    """Solver weights (or any float array) of the reference as a tensor."""
    return torch.tensor(np.asarray(w), device=resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (bf16 widened to float32, which numpy
    lacks)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
