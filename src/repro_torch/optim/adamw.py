"""Optimizers: AdamW and Adafactor (torch counterpart of
``repro/optim/adamw.py``), with the reference's arithmetic: float32
moments, the learning rate and bias corrections in float32, clipped
gradients cast back to the gradient's dtype.

**Reference leaves.**  The reference's unit is a leaf of its parameter
tree, and its layers are *stacked*: ``params["layers"]["attn"]["wq"]`` has
a leading axis of L layers (the hybrid's Mamba layers two, ``(n_super,
attn_every)``).  Three of its rules read that stacked shape:
weight decay applies to leaves of two or more dimensions (so a stacked
norm scale ``(L, d)`` decays, ``final_norm``'s ``(d,)`` does not),
Adafactor factors every leaf of two or more dimensions (for a stacked
vector ``vc`` averages across the layers), and Adafactor's RMS update clip
is taken over the whole stacked leaf.  The port holds one parameter per
layer, so the optimizer works on the model's description of that tree
(:class:`repro_torch.models.leaves.Leaf` groups, from
``reference_leaves()``): the members the reference stacks and the leading
shape it stacks them in.  Every shape rule reads the group's stacked shape; the state
is kept per group in that stacked shape, keyed by the reference's path
(``layers/attn/wq``), so checkpoints carry the reference's keys.

The update runs in place on the parameters and the state (the reference
returns new trees): at full width a copy of either would not fit beside
the other.  A leaf of three or more dimensions and at least
:data:`_CHUNK_THRESHOLD` elements is updated slice by slice over its
leading axis, as the reference's ``_maybe_chunked`` does: the slices'
temporaries are a layer's size, and Adafactor's statistics are then taken
per slice, as there.

On a live mesh :func:`apply_updates_zero1` runs the same arithmetic as
ZeRO-1: each rank holds its region of the moments (AdamW) or of the
factored statistics (Adafactor) under ``opt_state_specs``
(``distributed/lm_shard.py``).  AdamW's update is elementwise
(:func:`_adamw`); Adafactor's statistics span rows, columns and the unit,
so the mesh sums them over the ranks and then runs the same element
arithmetic (:class:`Adafactor`) on each rank's block.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.models.leaves import Leaf, Leaves
from repro_torch.roofline import trace_cost as TC


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


_CHUNK_THRESHOLD = 1 << 30     # elements; ~2 GB bf16 / 4 GB f32


def _chunked(leaf: Leaf) -> bool:
    return len(leaf.shape) >= 3 and leaf.numel >= _CHUNK_THRESHOLD


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``, in float32 on
    ``step``'s device."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def init_opt_state(cfg: OptConfig, leaves: Leaves) -> Dict:
    """Zero state in each leaf's stacked shape, on its members' device:
    ``{"mu", "nu", "step"}`` (AdamW) or ``{"fac", "step"}`` (Adafactor:
    ``{"v"}`` for a 1-D leaf, else row and column statistics ``vr``
    ``shape[:-1]`` and ``vc`` ``shape[:-2] + shape[-1:]``)."""
    dev = next(iter(leaves.values())).members[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.kind == "adamw":
        return {"mu": {k: _zeros(v.shape, v.members[0])
                       for k, v in leaves.items()},
                "nu": {k: _zeros(v.shape, v.members[0])
                       for k, v in leaves.items()},
                "step": step}
    if cfg.kind == "adafactor":
        def facs(leaf: Leaf):
            s, m = leaf.shape, leaf.members[0]
            if len(s) < 2:
                return {"v": _zeros(s, m)}
            return {"vr": _zeros(s[:-1], m), "vc": _zeros(s[:-2] + s[-1:], m)}
        return {"fac": {k: facs(v) for k, v in leaves.items()}, "step": step}
    raise ValueError(cfg.kind)


def global_norm(grads: Dict[str, Sequence[torch.Tensor]]) -> torch.Tensor:
    """The float32 2-norm over every tensor, leaves in the reference's
    order (sorted paths)."""
    total = None
    for k in sorted(grads):
        sq = sum(torch.sum(torch.square(g.float()))
                 for g in _members(grads[k]))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, Sequence[torch.Tensor]],
                        max_norm: float) -> torch.Tensor:
    """Scale every gradient in place by ``min(1, max_norm / norm)`` (in
    float32, cast back to its dtype); returns the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for gs in grads.values():
        for g in _members(gs):
            g.copy_((g.float() * scale).to(g.dtype))
    return norm


def _members(items):
    """A leaf's members (or their gradients, or one unit's zipped
    operands) in order; under a trace two of them, the second standing for
    the rest (``roofline.trace_cost.classes``: they cost the same)."""
    return TC.classes("optimizer.members", items, key=lambda t: None)


def _units(leaf: Leaf, grads: Sequence[torch.Tensor], state: Dict):
    """(a :class:`Leaf`, its gradients, its state views) for each unit the
    update takes whole: the slices over the leading axis of a chunked leaf
    (a stacked leaf's groups of members, an unstacked one's rows), else
    the whole leaf."""
    if not _chunked(leaf):
        return [(leaf, list(grads), state)]
    if not leaf.lead:
        return [(Leaf([m], lead=()), [g], {k: s[i] for k, s in state.items()})
                for i, (m, g) in enumerate(zip(leaf.members[0], grads[0]))]
    per = len(leaf.members) // leaf.lead[0]
    return [(Leaf(leaf.members[i * per:(i + 1) * per], lead=leaf.lead[1:]),
             list(grads[i * per:(i + 1) * per]),
             {k: s[i] for k, s in state.items()})
            for i in range(leaf.lead[0])]


def _adamw(cfg: OptConfig, p32: torch.Tensor, g32: torch.Tensor,
           mu: torch.Tensor, nu: torch.Tensor, bc1, bc2, lr,
           decay: bool) -> torch.Tensor:
    """AdamW on one tensor: updates ``mu`` and ``nu`` in place, returns the
    new float32 weight."""
    mu.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
    nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
    d = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
    if decay:
        d = d + cfg.weight_decay * p32
    return p32 - lr * d


#: Adafactor's floor: added to every squared gradient, under the row
#: statistics' mean and the RMS
_D2 = 1e-30


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Adafactor's element arithmetic at one step's learning rate (beta1
    0, factored second moment, the update's RMS clip): what
    :func:`apply_updates` runs on a whole unit and the mesh
    (:meth:`repro_torch.distributed.lm_shard.ShardedLM.apply_updates`) on
    each rank's block, from statistics summed over the ranks."""
    cfg: OptConfig
    lr: torch.Tensor

    @staticmethod
    def square(g32: torch.Tensor) -> torch.Tensor:
        """The squared gradient the statistics average, floored."""
        return torch.square(g32) + _D2

    def moment(self, old: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
        """A statistic's new value from its old one and the mean of
        :meth:`square` it takes in."""
        return self.cfg.b2 * old + (1 - self.cfg.b2) * mean

    @staticmethod
    def row_factor(vr: torch.Tensor) -> torch.Tensor:
        """``vr`` over its mean along its last axis (clamped to the
        floor)."""
        return vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=_D2)

    def direction(self, g32: torch.Tensor, second: torch.Tensor
                  ) -> torch.Tensor:
        """The unclipped update of ``g32`` under the second moment
        ``second`` (``v``, or the factors' product, broadcast to it)."""
        return g32 * torch.rsqrt(second + self.cfg.eps)

    @staticmethod
    def rms(mean_sq: torch.Tensor) -> torch.Tensor:
        """The update's RMS from the mean of its squares over the unit."""
        return torch.sqrt(mean_sq + _D2)

    def step(self, p32: torch.Tensor, d: torch.Tensor, rms: torch.Tensor,
             decay: bool) -> torch.Tensor:
        """The new float32 weight: ``d`` clipped by ``rms``, weight decay
        on a unit of two or more dimensions."""
        d = d / torch.clamp(rms, min=1.0)
        if decay:
            d = d + self.cfg.weight_decay * p32
        return p32 - self.lr * d


def _bias_corrections(cfg: OptConfig, step: torch.Tensor):
    s32 = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=s32.device), s32)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=s32.device), s32)
    return bc1, bc2


@torch.no_grad()
def apply_updates_zero1(cfg: OptConfig, sharded,
                        grads: Dict[str, Sequence[torch.Tensor]], state: Dict
                        ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """One optimizer step on a live mesh (ZeRO-1,
    :meth:`repro_torch.distributed.lm_shard.ShardedLM.apply_updates`):
    ``grads`` are the parameters' blocks (summed over the batch axes),
    ``state`` holds each rank's regions of the moments or factors
    (``opt_state_specs``).  The arithmetic is :func:`apply_updates`'s."""
    if cfg.kind not in ("adamw", "adafactor"):
        raise ValueError(cfg.kind)
    state["step"] += 1
    lr = schedule(cfg, state["step"])
    if cfg.kind == "adafactor":
        update = Adafactor(cfg, lr)
    else:
        bc1, bc2 = _bias_corrections(cfg, state["step"])

        def update(p32, g32, mu, nu, decay):
            return _adamw(cfg, p32, g32, mu, nu, bc1, bc2, lr, decay)

    gnorm = sharded.apply_updates(cfg, grads, state, update)
    return state, {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def apply_updates(cfg: OptConfig, leaves: Leaves,
                  grads: Dict[str, Sequence[torch.Tensor]], state: Dict
                  ) -> Tuple[Leaves, Dict, Dict[str, torch.Tensor]]:
    """One optimizer step over ``leaves`` with ``grads`` (the same paths,
    one gradient per member).  Clips the gradients, then updates the
    parameters and ``state`` in place; returns them with the metrics
    ``grad_norm`` (before clipping) and ``lr``."""
    gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    state["step"] += 1
    step = state["step"]
    lr = schedule(cfg, step)
    if cfg.kind == "adamw":
        bc1, bc2 = _bias_corrections(cfg, step)
        for path, leaf in leaves.items():
            decay = len(leaf.shape) >= 2
            moments = {"mu": state["mu"][path], "nu": state["nu"][path]}
            for unit, gs, st in _units(leaf, grads[path], moments):
                for p, g, mu, nu in _members(zip(
                        unit.members, gs, unit.unstack(st["mu"]),
                        unit.unstack(st["nu"]))):
                    new = _adamw(cfg, p.float(), g.float(), mu, nu, bc1,
                                 bc2, lr, decay)
                    p.copy_(new.to(p.dtype))
        return leaves, state, {"grad_norm": gnorm, "lr": lr}
    if cfg.kind != "adafactor":
        raise ValueError(cfg.kind)

    # -- adafactor (beta1 = 0, factored second moment) ------------------------
    af = Adafactor(cfg, lr)
    for path, leaf in leaves.items():
        for unit, gs, fac in _units(leaf, grads[path], state["fac"][path]):
            g32 = unit.stack([g.float() for g in gs])
            g2 = af.square(g32)
            if g32.dim() < 2:
                v = af.moment(fac["v"], g2)
                d = af.direction(g32, v)
                fac["v"].copy_(v)
            else:
                vr = af.moment(fac["vr"], g2.mean(dim=-1))
                vc = af.moment(fac["vc"], g2.mean(dim=-2))
                d = af.direction(g32, af.row_factor(vr)[..., None]
                                 * vc[..., None, :])
                fac["vr"].copy_(vr)
                fac["vc"].copy_(vc)
            # update clipping (Adafactor's RMS rule), over the whole unit
            rms = af.rms(torch.mean(torch.square(d)))
            p32 = unit.stack([p.float() for p in unit.members])
            new = af.step(p32, d, rms, d.dim() >= 2)
            for p, q in zip(unit.members, unit.unstack(new)):
                p.copy_(q.to(p.dtype))
    return leaves, state, {"grad_norm": gnorm, "lr": lr}
