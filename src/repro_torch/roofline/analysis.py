"""Roofline terms on an NVIDIA H100 SXM5.

Torch counterpart of ``repro/roofline/analysis.py``, with the card's data
sheet in place of the reference's TPU constants:

  compute    = FLOPs per card / peak FLOP/s
  memory     = bytes per card / HBM bytes/s
  collective = collective bytes per card / NVLink bytes/s per direction

The port has no compiled HLO to count bytes in.  The LiFE engines take
their bytes from the analytic compulsory-byte formulas of
:mod:`repro_torch.roofline.spmv_bytes` instead, and
:func:`collective_bytes` takes the collectives a
:mod:`~repro_torch.distributed.mesh` mesh recorded as it issued them, with
the reference's ring factors per kind.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Tuple

#: NVIDIA H100 SXM5 data sheet at its 700 W power limit
HW = dict(
    peak_flops=989e12,        # dense bf16 tensor-core FLOP/s
    fp32_flops=67e12,         # fp32 FLOP/s outside the tensor cores
    hbm_bw=3.35e12,           # HBM3 bytes/s
    link_bw=450e9,            # NVLink bytes/s per direction
)


def bound(bytes_moved: float, flops: float,
          flops_per_s: Optional[float] = None) -> Tuple[float, str]:
    """The least seconds the card could take for ``bytes_moved`` bytes and
    ``flops`` operations: the larger of the two times, and which one it
    was (``"bytes"`` or ``"operations"``).  ``flops_per_s`` defaults to
    the fp32 rate, the rate of the LiFE kernels' sums."""
    rate = HW["fp32_flops"] if flops_per_s is None else flops_per_s
    t_bytes = bytes_moved / HW["hbm_bw"]
    t_ops = flops / rate
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: the collective kinds the reference counts, in its order
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def collective_bytes(records: Iterable[Tuple[str, float, int]]
                     ) -> Dict[str, Any]:
    """Bytes each device moves, by collective kind, for collectives given
    as ``(kind, bytes, group size)`` (a mesh's ``collectives``): the
    reference's ring factors on the bytes of one device's operand (the
    result, for all-gather and reduce-scatter)::

      all-gather          size * (g-1)/g
      reduce-scatter      size * (g-1)
      all-reduce          2 * size * (g-1)/g
      all-to-all          size * (g-1)/g
      collective-permute  size

    A group of one moves nothing and is not counted.  Returns the
    reference's dict: one entry per kind, ``total`` and ``counts``.
    """
    out: Dict[str, Any] = {k: 0.0 for k in COLLECTIVE_KINDS}
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    for kind, size, g in records:
        if kind not in out:
            raise ValueError(f"collective kind must be one of "
                             f"{COLLECTIVE_KINDS}, got {kind!r}")
        if g <= 1:
            continue
        if kind == "all-gather":
            moved = size * (g - 1) / g
        elif kind == "reduce-scatter":
            moved = size * (g - 1)
        elif kind == "all-reduce":
            moved = 2 * size * (g - 1) / g
        elif kind == "all-to-all":
            moved = size * (g - 1) / g
        else:  # collective-permute
            moved = size
        out[kind] += moved
        counts[kind] += 1
    out["total"] = sum(out[k] for k in COLLECTIVE_KINDS)
    out["counts"] = counts
    return out


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    model_flops: float
    useful_ratio: float
    dominant: str
    bound_s: float

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def roofline(flops_per_chip: float, bytes_per_chip: float,
             coll_bytes_per_chip: float, n_chips: int,
             model_flops_global: float) -> Roofline:
    """The three terms for one program on ``n_chips`` cards, the dominant
    one and the share of its FLOPs the model needs."""
    compute_s = flops_per_chip / HW["peak_flops"]
    memory_s = bytes_per_chip / HW["hbm_bw"]
    collective_s = coll_bytes_per_chip / HW["link_bw"]
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    flops_global = flops_per_chip * n_chips
    useful = model_flops_global / flops_global if flops_global else 0.0
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        flops_per_chip=flops_per_chip, bytes_per_chip=bytes_per_chip,
        coll_bytes_per_chip=coll_bytes_per_chip,
        model_flops=model_flops_global, useful_ratio=useful,
        dominant=dominant, bound_s=max(terms.values()))


def model_flops(cfg, shape_name: str, seq: int, batch: int, kind: str) -> float:
    """MODEL_FLOPS: 6*N*D train (fwd+bwd), 2*N_active*D inference."""
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * seq * batch
    if kind == "prefill":
        return 2.0 * n_active * seq * batch
    # decode: one token per sequence
    return 2.0 * n_active * batch


def mfu_fraction(r: Roofline, n_chips: int, kind: str) -> float:
    """Upper bound on model-FLOPs utilization implied by the terms: useful
    model flops / (cards * peak * bound time)."""
    denom = n_chips * HW["peak_flops"] * max(r.bound_s, 1e-30)
    return r.model_flops / denom
