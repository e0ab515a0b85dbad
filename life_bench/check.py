"""How ``correct`` is decided: the program's outputs against the plain
reference (``reference.py``) on the same generated tensors.

Numbers read, each the largest over every subject of the run:

- ``dsc_rel``: the executor's ``M w_true`` at the timed sizes, its widest
  gap from the reference over the reference's largest magnitude;
- ``wc_rel``: the same for ``Mᵀ b``;
- ``w_early_l2``: the weights of the window's judged solve (the last one
  that completed, else the one in progress) after its first
  ``early_iters`` iterations against the reference's, the norm of the
  gap over the reference's norm;
- ``w_l2``: the same for the judged solve's weights after all of its
  iterations;
- ``loss_l2``: the judged solve's loss at every iteration, the same way;
- ``final_loss_rel``: every completed solve's last loss against the
  reference's, the widest relative gap;
- ``w_early_rel``, ``w_rel`` (after all of the judged solve's
  iterations) and ``loss_rel``: the widest gaps of the weights and of the
  losses, read for the record.  SBBNNLS carries each rounding forward
  through its step sizes and clamps, and one weight that meets its clamp
  a step apart on the two sides sets a widest gap; by 200 iterations
  float32 and bfloat16 storage read alike on ``w_rel``.

Only the numbers that a cell's limits file names are compared; a number
is within its limit when it is at most the limit (NaN never is).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from life_bench import reference


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest gap over the reference's largest magnitude."""
    ref = ref.double()
    return float((a.double() - ref).abs().max() / ref.abs().max())


def _l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Norm of the gap over the reference's norm."""
    ref = ref.double()
    return float(torch.linalg.vector_norm(a.double() - ref)
                 / torch.linalg.vector_norm(ref))


def numbers(data: dict, config: dict, window: dict, outputs: dict
            ) -> Dict[str, float]:
    """Every number compared, from the reference run subject by subject."""
    gx, gy, gz = config["grid"]
    nv, nf = gx * gy * gz, config["n_fibers"]
    batched = window["w"].dim() == 2
    out: Dict[str, float] = {}

    def worst(name: str, value: Optional[float]) -> None:
        if value is not None:
            out[name] = max(out.get(name, value), value)

    n = window["judged_iters"]
    for s, sub in enumerate(data["subjects"]):
        op = reference.Operator(sub["atoms"], sub["voxels"], sub["fibers"],
                                sub["values"], data["dictionary"], nv, nf)
        worst("dsc_rel", _rel(outputs["y"][s], op.dsc(sub["w_true"])))
        worst("wc_rel", _rel(outputs["g"][s], op.wc(sub["b"])))
        early = window["early_iters"]
        w_ref, l_ref, kept = reference.sbbnnls(op, sub["b"], n, keep=(early,))
        w_p = window["w"][s] if batched else window["w"]
        l_p = window["losses"][s] if batched else window["losses"]
        worst("w_rel", _rel(w_p, w_ref))
        worst("w_l2", _l2(w_p, w_ref))
        if window["w_early"] is not None:
            w_e = window["w_early"][s] if batched else window["w_early"]
            worst("w_early_rel", _rel(w_e, kept[early]))
            worst("w_early_l2", _l2(w_e, kept[early]))
        if n:
            worst("loss_rel", float(((l_p.double() - l_ref).abs()
                                     / l_ref).max()))
            worst("loss_l2", _l2(l_p, l_ref))
        finals = window["finals"]
        if finals is not None and n == window["solve_iters"]:
            f_p = finals[s] if batched else finals
            worst("final_loss_rel",
                  float(((f_p.double() - l_ref[-1]).abs()
                         / l_ref[-1]).max()))
        del op
    return out


def compare(found: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, dict]:
    """Each limited number beside its limit; a limited number the run did
    not produce reads NaN and fails."""
    return {name: dict(value=found.get(name, float("nan")), limit=limit,
                       ok=bool(found.get(name, float("nan")) <= limit))
            for name, limit in limits.items()}
