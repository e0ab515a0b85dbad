"""Sparse-format subsystem: swappable Phi layouts (torch counterpart of
``repro/formats``).

Importing this package registers the built-in formats:

  coo   sorted-COO PhiTensor (the canonical layout)      — formats/coo.py
  sell  sliced-ELL layout for direct row-block
        accumulation (kernels B3/B4)                      — formats/sell.py
  alto  bit-interleaved linearized single-index encoding  — formats/alto.py
  fcoo  segment-flagged linearization; ONE resident copy
        serves both ops (kernels B5/B6)                   — formats/fcoo.py

``formats.select`` picks one per dataset; engines reach it through
``LifeConfig(format="auto")``.  The mesh partition's layout
(``formats/shard.py:ShardPhi``) is not a registered format: the ``shard``
and ``shard-sell`` executors consume it.
"""
from repro_torch.formats.base import (FORMATS, FORMAT_VERSION, FormatPlan,
                                      PhiFormat, canonical_triples,
                                      format_names, get_format,
                                      register_format)
from repro_torch.formats.alto import AltoPhi
from repro_torch.formats.coo import CooPhi
from repro_torch.formats.fcoo import FcooPhi
from repro_torch.formats.sell import SellPhi

__all__ = [
    "FORMATS", "FORMAT_VERSION", "FormatPlan", "PhiFormat",
    "canonical_triples", "format_names", "get_format", "register_format",
    "AltoPhi", "CooPhi", "FcooPhi", "SellPhi",
]
