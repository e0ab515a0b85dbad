"""The benchmark's data: a synthetic STN96-like connectome made on the
device from the seed.

It follows the semantics of the port's ``synth_connectome`` (streamlines
stepped through a voxel box, each step's (voxel, orientation) pair
quantised to the nearest dictionary atom by axial symmetry, repeated
(atom, voxel, fiber) triples merged with their values summed, a sparse
nonnegative ``w_true`` and ``b = M w_true + noise``) but not its random
stream: every fiber steps at once, and the draws come from
``torch.Generator`` s on the device in a few large calls.

A subject slot keeps its streamlines from run to run, as a dataset
does: they are drawn from ``ANATOMY_SEED`` plus the slot, so every seed
gives the engine the same coefficients and the same work.  The run's
seed draws ``w_true`` and the noise, so ``b``.  (Drawing the order of
the fibers from the seed as well moved the COO cell's rate by 1% from
seed to seed.)  The same seed on the same device gives the same
tensors.

The configuration sets the step length in voxels (``step``) beside the
curvature and the length in steps: the port's generator steps 0.75
voxel, which gives about 31 coefficients a fiber for iFOD1; a
first-order tracker's 0.1 voxel with longer streamlines gives the
density of the published connectomes (see ``configs/``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from life_bench import reference

#: the seed of the shared dictionary's gradient directions: the
#: dictionary depends on the acquisition, not the subject
DICTIONARY_SEED = 7
#: slot ``s``'s streamlines are drawn from ``ANATOMY_SEED + s``
ANATOMY_SEED = 1905
#: fibers quantised at once (bounds the (fibers, atoms) product)
ATOM_BLOCK = 65536


def fibonacci_sphere(n: int) -> torch.Tensor:
    """``n`` quasi-uniform unit directions, float64 ``(n, 3)``."""
    i = torch.arange(n, dtype=torch.float64) + 0.5
    phi = torch.arccos(1 - 2 * i / n)
    theta = math.pi * (1 + 5 ** 0.5) * i
    return torch.stack([torch.cos(theta) * torch.sin(phi),
                        torch.sin(theta) * torch.sin(phi), torch.cos(phi)],
                       dim=1)


def make_dictionary(n_atoms: int, n_theta: int,
                    device: torch.device) -> torch.Tensor:
    """The stick-model dictionary ``(Na, Ntheta)``, float32, demeaned per
    atom: ``exp(-2 (g . n)²)`` for atom direction ``n`` and gradient
    direction ``g``."""
    gen = torch.Generator().manual_seed(DICTIONARY_SEED)
    grad = torch.randn((n_theta, 3), generator=gen, dtype=torch.float64)
    grad = grad / grad.norm(dim=1, keepdim=True)
    cos2 = (grad @ fibonacci_sphere(n_atoms).T) ** 2
    sig = torch.exp(-2.0 * cos2).T
    sig = sig - sig.mean(dim=1, keepdim=True)
    return sig.to(device=device, dtype=torch.float32).contiguous()


def streamlines(cfg: dict, gen: torch.Generator, atom_dirs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every fiber's steps at once: (atoms, voxels, fibers) of each step
    taken inside the box, int64, before merging.  The steps stop early
    once every fiber has ended or left the box."""
    dev = atom_dirs.device
    nf = cfg["n_fibers"]
    gx, gy, gz = cfg["grid"]
    step, curvature, mean_len, jitter = (cfg["step"], cfg["curvature"],
                                         cfg["mean_len"], cfg["len_jitter"])
    lo = torch.tensor([2.0, 2.0, 2.0], device=dev)
    hi = torch.tensor([gx - 2.0, gy - 2.0, gz - 2.0], device=dev)
    pos = lo + (hi - lo) * torch.rand((nf, 3), generator=gen, device=dev)
    d = torch.randn((nf, 3), generator=gen, device=dev)
    d = d / d.norm(dim=1, keepdim=True)
    n_steps = (mean_len + jitter * torch.randn(
        (nf,), generator=gen, device=dev)).long().clamp_min(4)
    max_steps = int(n_steps.max())
    turns = (torch.randn((max_steps, nf, 3), generator=gen, device=dev)
             if curvature > 0 else None)
    box = torch.tensor([gx, gy, gz], device=dev)
    stride = torch.tensor([gy * gz, gz, 1], device=dev)
    alive = torch.ones((nf,), dtype=torch.bool, device=dev)
    atoms, voxels, masks = [], [], []
    for t in range(max_steps):
        if curvature > 0:
            d = d + curvature * turns[t]
            d = d / d.norm(dim=1, keepdim=True)
        pos = pos + step * d
        v = torch.floor(pos).long()
        alive &= (t < n_steps) & ((v >= 0) & (v < box)).all(dim=1)
        voxels.append((v.clamp(min=0) * stride).sum(dim=1).int())
        atoms.append(torch.cat([
            torch.argmax(torch.abs(d[i:i + ATOM_BLOCK] @ atom_dirs.T), dim=1)
            for i in range(0, nf, ATOM_BLOCK)]).int())
        masks.append(alive.clone())
        if t % 64 == 63 and not bool(alive.any()):
            break
    mask = torch.stack(masks)
    fibers = torch.arange(nf, device=dev).expand(len(masks), nf)[mask]
    return (torch.stack(atoms)[mask].long(), torch.stack(voxels)[mask].long(),
            fibers)


def subject(cfg: dict, seed: int, dictionary: torch.Tensor, slot: int = 0
            ) -> Dict[str, torch.Tensor]:
    """Subject slot ``slot`` drawn from ``seed``: the merged coefficients
    (int32 indices, float32 values, ordered by (atom, voxel, fiber)),
    ``w_true`` and ``b``, all on the dictionary's device."""
    dev = dictionary.device
    nf = cfg["n_fibers"]
    gx, gy, gz = cfg["grid"]
    nv = gx * gy * gz
    atom_dirs = fibonacci_sphere(dictionary.shape[0]).to(
        device=dev, dtype=torch.float32)
    anatomy = torch.Generator(device=dev).manual_seed(ANATOMY_SEED + slot)
    a, v, f = streamlines(cfg, anatomy, atom_dirs)
    key, counts = torch.unique((a * nv + v) * nf + f, return_counts=True)
    atoms = (key // nf) // nv
    voxels = (key // nf) % nv
    fibers = key % nf
    # a merged value is the length of its equal steps
    values = counts.to(torch.float32) * cfg["step"]
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    w_true = torch.rand((nf,), generator=gen, device=dev)
    w_true[torch.rand((nf,), generator=gen, device=dev)
           > cfg["active_frac"]] = 0.0
    noise = torch.randn((nv, dictionary.shape[1]), generator=gen, device=dev)
    op = reference.Operator(atoms, voxels, fibers, values, dictionary, nv, nf)
    b = (op.dsc(w_true) + cfg["noise"] * noise.double()).to(torch.float32)
    return dict(atoms=atoms.int(), voxels=voxels.int(), fibers=fibers.int(),
                values=values, w_true=w_true, b=b)
