"""PhiFormat protocol and format registry.

Torch counterpart of ``repro/formats/base.py``.  The paper's argument is
that SpMV speed is decided by the data *representation*, so the Phi layout
is a swappable object:

  * every concrete layout (:mod:`~repro_torch.formats.coo`,
    :mod:`~repro_torch.formats.sell`, :mod:`~repro_torch.formats.alto`,
    :mod:`~repro_torch.formats.fcoo`) registers itself under a name;
  * all share one contract: ``encode`` from the canonical COO
    :class:`~repro_torch.core.std.PhiTensor` into host numpy arrays,
    ``decode`` back to the *exact* same coefficient multiset (order may
    differ) on the device the input lay on, and storage accounting
    (``nbytes``, ``padding_overhead``);
  * :mod:`~repro_torch.formats.select` picks one per dataset, and the
    choice is a :class:`FormatPlan` kept in the persistent plan cache.

The encoders are host numpy, as in the reference, so an encoding can be
compared array for array with the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Protocol, Tuple, runtime_checkable

import numpy as np

from repro_torch.bridge import to_numpy
from repro_torch.core.std import PhiTensor

#: bump on any incompatible change to a format's on-disk/plan representation
FORMAT_VERSION = 1

#: output ("row") dimension per SpMV op: voxel rows for DSC, fiber rows
#: for WC
OUTPUT_DIMS = {"dsc": "voxel", "wc": "fiber"}


@runtime_checkable
class PhiFormat(Protocol):
    """Structural contract every concrete Phi layout satisfies."""

    name: ClassVar[str]

    @classmethod
    def encode(cls, phi: PhiTensor, *, op: str = "dsc", **params) -> "PhiFormat":
        """Build the layout from the canonical COO tensor.

        ``op`` ("dsc"/"wc") matters only for per-op layouts (SELL, COO);
        one-copy layouts (ALTO, F-COO) ignore it.  ``params`` is the layout
        geometry (``row_tile``/``slot_tile``, ``c_tile``/``seg_tile``).
        """
        ...

    def decode(self) -> PhiTensor:
        """The exact coefficient multiset of the input, on its device."""
        ...

    @property
    def nbytes(self) -> int:
        """Resident bytes of the encoded layout (indices + values)."""
        ...

    @property
    def padding_overhead(self) -> float:
        """Stored slots / real coefficients - 1 (0.0 = no padding waste)."""
        ...


FORMATS: Dict[str, type] = {}


def register_format(cls):
    """Class decorator: register a PhiFormat implementation by ``cls.name``."""
    name = cls.name
    if name in FORMATS:
        raise ValueError(f"format {name!r} already registered")
    FORMATS[name] = cls
    return cls


def format_names() -> Tuple[str, ...]:
    """All registered format names, sorted."""
    return tuple(sorted(FORMATS))


def get_format(name: str):
    """The registered PhiFormat class for ``name``.

    Raises:
        ValueError: when no format is registered under ``name``.
    """
    if name not in FORMATS:
        raise ValueError(f"format must be one of {format_names()}, got {name!r}")
    return FORMATS[name]


def canonical_triples(phi: PhiTensor) -> Tuple[np.ndarray, ...]:
    """(atoms, voxels, fibers, values) sorted by (atom, voxel, fiber).

    Round trips compare layouts in this order because formats are free to
    permute coefficients; the multiset of (triple, value) pairs is the
    invariant."""
    a = to_numpy(phi.atoms).astype(np.int64)
    v = to_numpy(phi.voxels).astype(np.int64)
    f = to_numpy(phi.fibers).astype(np.int64)
    vals = to_numpy(phi.values)
    order = np.lexsort((f, v, a))
    return a[order], v[order], f[order], vals[order]


@dataclasses.dataclass
class FormatPlan:
    """Per-dataset format choice, kept in the PlanCache.

    ``format``: chosen format name; ``reason``: how it was decided —
      "heuristic"  inspector run-length statistics were decisive;
      "autotune"   the measured rung timed the candidates;
      "explicit"   the caller forced ``config.format``;
      "predicted"  a trained predictor answered with zero measurements
                   (``repro_torch.learn``; refined in place later).
    ``params``: layout geometry (row_tile / slot_tile); ``stats``:
    the inspector statistics the decision was based on.
    """

    format: str
    reason: str = "heuristic"
    params: Dict[str, int] = dataclasses.field(default_factory=dict)
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        """One-line human-readable summary (format, reason, geometry)."""
        ps = ",".join(f"{k}={v}" for k, v in sorted(self.params.items()))
        return f"format={self.format} ({self.reason}{'; ' + ps if ps else ''})"
