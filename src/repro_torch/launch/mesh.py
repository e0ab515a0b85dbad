"""Meshes for the LM (torch counterpart of ``repro/launch/mesh.py``).

Two meshes share the reference's interface, ``axis_names`` and ``shape``
(a mapping from each axis name to its size):

  :class:`ShapeMesh`  axis names and sizes, no ranks.
                      :func:`make_production_mesh` returns one, so the
                      sharding rules can read production shapes without
                      256 processes; activated on one process
                      (``distributed/hints.py``) it fixes the MoE's
                      dispatch groups and the attention branch of that
                      mesh without running a collective.
  :class:`HostMesh`   a ``(data, model)`` mesh over the current
                      ``torch.distributed`` process group.  Rank
                      ``r * C + c`` is cell ``(r, c)``, as
                      ``distributed/mesh.py`` numbers the LiFE cells;
                      one group per mesh row (the ``model`` axis) and one
                      per column (the ``data`` axis) carry the
                      collectives the LM needs.  Without a process group
                      the world is this one process, a ``(1, 1)`` mesh
                      whose collectives do nothing.

Under gloo a CUDA tensor is reduced or gathered on the card.  If this
build's gloo refuses one, the mesh stages every later collective through
host tensors, says so on stderr and sets ``staged``: it never runs on the
host silently.  Every collective is recorded as ``(kind, bytes, group
size)`` in ``collectives`` (the bytes of this rank's operand; for an
all-gather and a reduce-scatter, of its result), what
:func:`repro_torch.roofline.analysis.collective_bytes` reads.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

#: the host mesh's axes, rows then columns (the reference's)
AXES = ("data", "model")


class ShapeMesh:
    """A mesh's axis names and sizes, without ranks."""

    live = False

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        if any(int(n) < 1 for n in shape):
            raise ValueError(f"mesh shape must be positive, got "
                             f"{tuple(shape)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(n) for a, n in
                                      zip(axis_names, shape)}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return (f"{type(self).__name__}("
                + ", ".join(f"{a}={n}" for a, n in self.shape.items()) + ")")


class HostMesh(ShapeMesh):
    """A ``(data, model)`` mesh of ``R x C`` cells over the process group
    (see the module docstring); ``device`` is this rank's.  Its groups
    and staging are a
    :class:`~repro_torch.distributed.mesh.ProcessGroupMesh`'s.

    Raises:
        ValueError: the process group's world size is not ``R * C``, or
            ``R * C > 1`` without a process group.
    """

    def __init__(self, R: int, C: int, device):
        super().__init__((R, C), AXES)
        import torch.distributed as dist
        self.device = torch.device(device)
        self.live = dist.is_available() and dist.is_initialized()
        self.collectives: List[Tuple[str, int, int]] = []
        if not self.live:
            if R * C != 1:
                raise ValueError(f"a {R} x {C} mesh needs a process group "
                                 f"of {R * C} ranks; there is none")
            self._pg, self.rank, self.backend = None, 0, None
            self.coords = {"data": 0, "model": 0}
            return
        from repro_torch.distributed.mesh import ProcessGroupMesh
        self._pg = ProcessGroupMesh(R, C, device=self.device)
        self.rank, self.backend = self._pg.rank, self._pg.backend
        self.coords = {"data": self._pg.r, "model": self._pg.c}

    @property
    def staged(self) -> bool:
        return self._pg is not None and self._pg.staged

    def axes_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str],
                   op: str = "sum") -> torch.Tensor:
        """Sum ``t`` (``op="max"``: its maximum) over the ranks that differ
        only along ``axes``, in place; returns ``t``."""
        n = self.axes_size(axes)
        if self.live and n > 1:
            self.collectives.append(("all-reduce",
                                     t.numel() * t.element_size(), n))
            key = tuple(a for a in AXES if a in axes)
            self._pg.all_reduce(t, key[0] if len(key) == 1 else key, op)
        return t

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int
                       ) -> torch.Tensor:
        """This rank's block along ``dim`` of ``t`` summed over mesh
        ``axis`` (the block at its coordinate), recorded as
        ``("reduce-scatter", bytes of the block, group size)``.  Where
        the backend has no reduce-scatter the process-group mesh runs an
        all-reduce and a ``narrow`` in its place (``rs_emulated``), which
        the record does not show."""
        n = self.shape[axis]
        if not self.live or n == 1:
            return t
        out = self._pg.reduce_scatter(t, axis, dim)
        self.collectives.append(("reduce-scatter",
                                 out.numel() * out.element_size(), n))
        return out

    @property
    def rs_emulated(self) -> tuple:
        """The device types whose reduce-scatters ran as all-reduces."""
        return tuple(sorted(self._pg.rs_emulated)) if self._pg else ()

    def all_gather(self, t: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """The ``t`` of every rank along mesh ``axis`` (this rank's
        neighbours, in coordinate order), concatenated along ``dim``."""
        n = self.shape[axis]
        if not self.live or n == 1:
            return t
        self.collectives.append(("all-gather",
                                 t.numel() * t.element_size() * n, n))
        return self._pg.all_gather(t, axis, dim)

    def barrier(self) -> None:
        if self.live:
            import torch.distributed as dist
            dist.barrier()


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """16 x 16 ``(data, model)`` (one pod, 256 chips) or 2 x 16 x 16
    ``(pod, data, model)``: shapes only."""
    if multi_pod:
        return ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    return ShapeMesh((16, 16), ("data", "model"))


def world_size() -> int:
    """The process group's world size, 1 without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_host_mesh(model: int = 1, device="cpu") -> HostMesh:
    """A ``(world // model, model)`` mesh over the current process group
    (the world is 1 without one); ``device`` is this rank's.

    Raises:
        ValueError: ``model`` does not divide the world.
    """
    n = world_size()
    if model < 1 or n % model:
        raise ValueError(f"--model-axis {model} does not divide the world "
                         f"of {n} process{'es' if n != 1 else ''}")
    return HostMesh(n // model, model, device)
