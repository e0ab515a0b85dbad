"""The reference's parameter layout over the port's parameters.

The reference's unit is a leaf of its parameter tree, and its layers are
*stacked*: ``params["layers"]["attn"]["wq"]`` has a leading axis of L
layers, and the hybrid family's Mamba layers two, ``(n_super,
attn_every)``.  The port holds one parameter per layer, so a model
describes the reference's tree as :class:`Leaf` groups
(``Transformer.reference_leaves()``): the members the reference stacks, in
row-major order, and the leading shape it stacks them in.  The
optimizer's shape rules and the checkpoints read this description.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

#: a path in the reference's parameter tree (``layers/attn/wq``,
#: ``prefix/#0/mlp/wo``) -> the port's parameters it groups
Leaves = Dict[str, "Leaf"]


class Leaf:
    """One leaf of the reference's tree: ``members`` stacked along the
    leading axes ``lead`` (``(L,)`` for a layer stack, even of one layer;
    ``(n_super, attn_every)`` for the hybrid's Mamba layers; members in
    row-major order), or, with ``lead == ()``, a single tensor.

    ``stacked=True`` without ``lead`` stacks the members along one axis,
    ``stacked=False`` is a single tensor."""

    def __init__(self, members: List[torch.Tensor], stacked: bool = None,
                 lead: Tuple[int, ...] = None):
        self.members = members
        if lead is None:
            lead = (len(members),) if stacked else ()
        self.lead = tuple(lead)
        if not self.lead and len(members) != 1:
            raise ValueError("an unstacked leaf holds one tensor")
        if len(members) != math.prod(self.lead):
            raise ValueError(f"a leaf stacked as {self.lead} holds "
                             f"{math.prod(self.lead)} tensors, not "
                             f"{len(members)}")

    @property
    def stacked(self) -> bool:
        return bool(self.lead)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.lead + tuple(self.members[0].shape)

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    def stack(self, ts: Sequence[torch.Tensor]) -> torch.Tensor:
        """One tensor per member (in members' order) as the leaf's
        stacked tensor of :attr:`shape`."""
        if not self.lead:
            return ts[0]
        return torch.stack(list(ts)).reshape(self.shape)

    def unstack(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A tensor of the leaf's :attr:`shape` as one view per member."""
        if not self.lead:
            return [t]
        return list(t.reshape((-1,) + tuple(self.members[0].shape)))
