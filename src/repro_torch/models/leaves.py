"""The reference's parameter layout over the port's parameters.

The reference's unit is a leaf of its parameter tree, and its layers are
*stacked*: ``params["layers"]["attn"]["wq"]`` has a leading axis of L
layers.  The port holds one parameter per layer, so a model describes the
reference's tree as :class:`Leaf` groups (``Transformer.reference_leaves()``):
the members the reference stacks, and whether it stacks them.  The
optimizer's shape rules and the checkpoints read this description.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

#: a path in the reference's parameter tree (``layers/attn/wq``,
#: ``prefix/#0/mlp/wo``) -> the port's parameters it groups
Leaves = Dict[str, "Leaf"]


@dataclasses.dataclass
class Leaf:
    """One leaf of the reference's tree: ``members`` stacked along a new
    leading axis when ``stacked`` (a layer stack, even of one layer), else
    a single tensor."""
    members: List[torch.Tensor]
    stacked: bool

    def __post_init__(self):
        if not self.stacked and len(self.members) != 1:
            raise ValueError("an unstacked leaf holds one tensor")

    @property
    def shape(self) -> Tuple[int, ...]:
        one = tuple(self.members[0].shape)
        return (len(self.members),) + one if self.stacked else one

    @property
    def numel(self) -> int:
        return math.prod(self.shape)
