"""Sorted-COO format: the canonical PhiTensor plus a remembered sort.

Torch counterpart of ``repro/formats/coo.py``: encode is a stable host sort
by the op's output dimension, decode applies the inverse permutation, so
the input order round-trips exactly.  Every COO executor (``naive``,
``opt``, ``opt-paper``, ``kernel``, ``auto``) consumes this layout.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import numpy as np

from repro_torch.core.restructure import sort_by_host
from repro_torch.core.std import PhiTensor
from repro_torch.formats.base import OUTPUT_DIMS, register_format


@register_format
@dataclasses.dataclass
class CooPhi:
    """COO coefficients stably sorted along ``sort_dim``.

    ``order`` is the applied permutation (original -> sorted), kept so
    ``decode`` restores the input order and plans can replay the sort.
    """

    name: ClassVar[str] = "coo"

    phi: PhiTensor                       # sorted coefficients
    sort_dim: str                        # "atom" | "voxel" | "fiber"
    order: np.ndarray                    # int64[Nc] permutation applied

    @classmethod
    def encode(cls, phi: PhiTensor, *, op: str = "dsc",
               sort_dim: Optional[str] = None, **_params) -> "CooPhi":
        dim = OUTPUT_DIMS[op] if sort_dim is None else sort_dim
        sorted_phi, order = sort_by_host(phi, dim)
        return cls(phi=sorted_phi, sort_dim=dim, order=np.asarray(order))

    def decode(self) -> PhiTensor:
        inverse = np.empty_like(self.order)
        inverse[self.order] = np.arange(self.order.size)
        return self.phi.take(inverse)

    @property
    def n_coeffs(self) -> int:
        return self.phi.n_coeffs

    @property
    def nbytes(self) -> int:
        p = self.phi
        return int(sum(t.numel() * t.element_size()
                       for t in (p.atoms, p.voxels, p.fibers, p.values)))

    @property
    def padding_overhead(self) -> float:
        return 0.0                      # COO stores exactly Nc slots
