"""Search-space enumeration for the kernel autotuner.

Torch counterpart of ``repro/tune/space.py``.  One table,
:data:`TUNABLE_TILES`, names the layout axes each kernel executor exposes.
In the reference they are Pallas tile shapes; in the port they are the
layout parameters the Hopper kernels take at run time:

  kernel       ``c_tile`` and ``row_tile`` of the COO tiles B1 and B2 walk
  kernel-sell  ``row_tile`` and ``slot_tile`` of the SELL layout of B3/B4
  kernel-fcoo  ``c_tile`` of the F-COO chunks of B5 and B6
  shard-sell   ``row_tile`` and ``slot_tile`` of every mesh cell's SELL
               layout (B3/B4 once per cell)

Block shapes and register budgets are compile-time constants of the
kernels and are not searched.  The reference also searches ``seg_tile``
for ``kernel-fcoo``; in the port it shapes only host metadata (B5 and B6
take no segment bound), so a search over it would time noise, and the
port leaves it out.  Executors without an entry (the plain-PyTorch paths)
have no layout axes; their space is the compute-dtype axis alone.

Candidate enumeration always includes the *current* config values, so the
measured winner is never worse than the config's own on the tuner's
objective.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

from repro_torch.tune.plan import COMPUTE_DTYPES

#: executor registry name -> the layout axes its kernels take
TUNABLE_TILES: Dict[str, Tuple[str, ...]] = {
    "kernel": ("c_tile", "row_tile"),
    "kernel-sell": ("row_tile", "slot_tile"),
    "kernel-fcoo": ("c_tile",),
    "shard-sell": ("row_tile", "slot_tile"),
}

#: per-axis candidate values, the reference's (the current config value
#: is always added)
AXIS_CANDIDATES: Dict[str, Tuple[int, ...]] = {
    "c_tile": (128, 256, 512),
    "row_tile": (8, 16),
    "slot_tile": (16, 32, 64),
    "seg_tile": (8, 16, 32),
}


def tile_axes(executor: str) -> Tuple[str, ...]:
    """Layout axes executor ``executor`` exposes (may be empty)."""
    return TUNABLE_TILES.get(executor, ())


def current_params(executor: str, config) -> Dict[str, int]:
    """The config's own values for the executor's layout axes."""
    return {ax: int(getattr(config, ax)) for ax in tile_axes(executor)}


def search_space(executor: str, config, *,
                 budget: int | None = None) -> List[dict]:
    """Candidate list: ``{"params": {axis: value}, "compute_dtype": str}``.

    The first candidate is always the current config under its requested
    (or fp32-first, when "auto") dtype, so truncating to ``budget`` never
    drops the default configuration.
    """
    axes = tile_axes(executor)
    cur = current_params(executor, config)
    requested = getattr(config, "compute_dtype", "fp32")
    dtypes = COMPUTE_DTYPES if requested == "auto" else (requested,)

    per_axis = [sorted(set(AXIS_CANDIDATES[ax]) | {cur[ax]}) for ax in axes]
    tiles = [dict(zip(axes, combo))
             for combo in itertools.product(*per_axis)] if axes else [{}]
    # current config first, so budget truncation keeps the default
    tiles.sort(key=lambda t: (t != cur, tuple(sorted(t.items()))))

    out: List[dict] = []
    for dt in dtypes:              # default tiles under every dtype first
        out.append(dict(params=dict(cur), compute_dtype=dt))
    for t in tiles:
        for dt in dtypes:
            cand = dict(params=dict(t), compute_dtype=dt)
            if cand not in out:
                out.append(cand)
    if budget is not None and budget > 0:
        out = out[:max(budget, len(dtypes))]
    return out
