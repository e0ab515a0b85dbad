"""ALTO: adaptive linearized single-index Phi encoding (arXiv:2403.06348).

Torch counterpart of ``repro/formats/alto.py``.  Each coefficient carries
ONE integer whose bits interleave the (atom, voxel, fiber) coordinates
round-robin from the least significant bit, a mode-agnostic
space-filling-curve order.  Sorting by it gives locality in every mode at
once, so one Phi copy feeds both DSC and WC; re-sorting is one flat
``argsort`` of a ``uint64`` vector and compaction a mask over two arrays.

Bit budget: ``bits(Na) + bits(Nv) + bits(Nf) <= 64``.  The encoding is host
numpy, bit for bit the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.bridge import to_numpy
from repro_torch.core.std import PhiTensor
from repro_torch.formats.base import register_format

MODES = ("atom", "voxel", "fiber")


def _mode_bits(n_atoms: int, n_voxels: int, n_fibers: int) -> Tuple[int, ...]:
    """Bits needed to represent the largest index of each mode."""
    return tuple(max(0, int(n - 1).bit_length())
                 for n in (n_atoms, n_voxels, n_fibers))


def _interleave_positions(bits: Tuple[int, ...]) -> Dict[str, List[int]]:
    """Round-robin bit placement from the LSB: round k assigns bit k of each
    mode that still has bits left."""
    pos: Dict[str, List[int]] = {m: [] for m in MODES}
    p = 0
    for k in range(max(bits) if bits else 0):
        for m, b in zip(MODES, bits):
            if k < b:
                pos[m].append(p)
                p += 1
    return pos


@register_format
@dataclasses.dataclass
class AltoPhi:
    """Linearized Phi: one uint64 index + one value per coefficient."""

    name: ClassVar[str] = "alto"

    lin: np.ndarray                      # uint64 (Nc,)
    values: np.ndarray                   # fp (Nc,)
    n_atoms: int
    n_voxels: int
    n_fibers: int
    device: str = "cpu"

    # -- encode / decode ------------------------------------------------------
    @classmethod
    def encode(cls, phi: PhiTensor, *, op: str = "dsc", **_params) -> "AltoPhi":
        """Interleave each coefficient's indices (a ``build.encode``
        span)."""
        bits = _mode_bits(phi.n_atoms, phi.n_voxels, phi.n_fibers)
        if sum(bits) > 64:
            raise ValueError(
                f"mode sizes need {sum(bits)} bits, uint64 has 64")
        pos = _interleave_positions(bits)
        with obs.span("build.encode", {"format": cls.name,
                                       "n_coeffs": phi.n_coeffs}):
            lin = np.zeros(phi.n_coeffs, np.uint64)
            for mode, idx in zip(MODES, (phi.atoms, phi.voxels,
                                         phi.fibers)):
                idx64 = to_numpy(idx).astype(np.uint64)
                for k, p in enumerate(pos[mode]):
                    lin |= (((idx64 >> np.uint64(k)) & np.uint64(1))
                            << np.uint64(p))
            return cls(lin=lin, values=to_numpy(phi.values).copy(),
                       n_atoms=phi.n_atoms, n_voxels=phi.n_voxels,
                       n_fibers=phi.n_fibers, device=str(phi.device))

    def _extract_mode(self, mode: str) -> np.ndarray:
        """De-interleave one mode's coordinate from the linearized index."""
        bits = _mode_bits(self.n_atoms, self.n_voxels, self.n_fibers)
        idx = np.zeros(self.lin.size, np.uint64)
        for k, p in enumerate(_interleave_positions(bits)[mode]):
            idx |= ((self.lin >> np.uint64(p)) & np.uint64(1)) << np.uint64(k)
        return idx.astype(np.int32)

    def decode(self) -> PhiTensor:
        atoms, voxels, fibers = (torch.as_tensor(self._extract_mode(m),
                                                 device=self.device)
                                 for m in MODES)
        return PhiTensor(
            atoms=atoms, voxels=voxels, fibers=fibers,
            values=torch.as_tensor(self.values, device=self.device),
            n_atoms=self.n_atoms, n_voxels=self.n_voxels,
            n_fibers=self.n_fibers)

    # -- host-side restructuring ---------------------------------------------
    def sort(self) -> Tuple["AltoPhi", np.ndarray]:
        """Order by the linearized index (the ALTO locality order).
        Returns (sorted AltoPhi, permutation); a ``build.sort`` span."""
        with obs.span("build.sort", {"dim": "alto",
                                     "n_coeffs": self.n_coeffs}):
            order = np.argsort(self.lin, kind="stable")
            return dataclasses.replace(
                self, lin=self.lin[order], values=self.values[order]), order

    def compact(self, keep: np.ndarray) -> "AltoPhi":
        """Drop coefficients where ``keep`` is False (weight compaction)."""
        keep = np.asarray(keep, bool)
        return dataclasses.replace(
            self, lin=self.lin[keep], values=self.values[keep])

    def fibers_of(self) -> np.ndarray:
        """Just the fiber coordinates (for weight-compaction masks) without
        paying for the full delinearization."""
        return self._extract_mode("fiber")

    # -- accounting -----------------------------------------------------------
    @property
    def n_coeffs(self) -> int:
        return int(self.lin.size)

    @property
    def nbytes(self) -> int:
        return int(self.lin.nbytes + self.values.nbytes)

    @property
    def padding_overhead(self) -> float:
        return 0.0                      # exactly Nc slots, no padding
